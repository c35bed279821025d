"""Writers of stand-in dataset files in each dataset's own on-disk format.

Test scaffolding, not a feature: the CPU tests and ``chip_smoke.py`` read
these files through the real readers (``data/lidar.py``,
``data/datasets.py`` ``ObjectPthDataset``, ``data/kortx.py``), because no
recording of SemanticKITTI, nuScenes, A2D2, ShapeNet or Kortx is in the
repository.  The points are ``data/synthetic.py`` sweeps (their wall
jitter smoothed along each beam) and object scans, drawn from ``seed``, in
metres; the synthetic classes (1 ground, 2 walls,
the rest objects) are renamed to each dataset's classes and written as its
raw label ids, so the readers' label maps run as on the real files:

  * SemanticKITTI: ``sequences/XX/velodyne/*.bin`` (float32 x, y, z,
    reflectance in acquisition order: one continuous sweep, beam after
    beam) and ``labels/*.label`` (uint32: the raw id through the inverse
    learning map, an instance id in the upper 16 bits of instance classes);
  * nuScenes: ``samples/LIDAR_TOP/*.pcd.bin`` (5 float32 channels, the
    ring index in channel 4, points in firing order: by azimuth across
    the rings), ``lidarseg/v1.0-trainval/<token>_lidarseg.bin`` (uint8 raw
    ids; none on the test split) and ``nuscenes_infos_{split}.pkl``;
  * A2D2: ``{split}/*.npz`` with points / reflectance / lidar_id /
    timestamp / labels over 5 sensors, timestamps in each sensor's firing
    order (beam after beam), the frame's points shuffled;
  * ShapeNet / Kortx objects: ``data_{num_points}_{resolution}_
    {line_density}_{laser_motion}_{split}.pth``, a ``types.SimpleNamespace``
    of tensors (pos, batch, curve_idxs with global ids, y as ShapeNet part
    ids, labels as categories, curvature);
  * a raw Kortx capture directory (``info.json`` and ``.csv`` views) for
    ``data.kortx.preprocess_kortx``.

:func:`write_for_config` writes what ``main.load_datasets`` reads for a
config and returns the ``data_path`` to give it.
"""

from __future__ import annotations

import json
import os
import pickle
import types
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.datasets import object_stem
from ..data.kortx import CATEGORY_NAMES
from ..data.lidar import NUSCENES_LEARNING_MAP
from ..data.synthetic import SENSOR_HEIGHT, lidar_sweep, object_scan
from ..run.globals import (KITTI_LEARNING_MAP_INV, SHAPENET_CATEGORY_NAMES,
                           SHAPENET_SEG_CLASSES)

# synthetic class (index) -> the dataset's train id: 1 ground, 2 walls, the
# objects' random classes spread over the rest
KITTI_CLASS_OF = np.array([0, 9, 13, 1, 6, 4, 15, 18, 2, 3, 5, 7, 8, 10, 11,
                           12, 14, 16, 17, 19])
NUSCENES_CLASS_OF = np.array([0, 11, 15, 4, 7, 10, 16, 1, 2, 3, 5, 6, 8, 9,
                              12, 13, 14])
A2D2_CLASS_OF = np.array([12, 9, 10, 0, 2, 8, 11, 3, 1, 4, 5, 6, 7])
KITTI_INSTANCE = range(1, 9)
# synthetic object shape (sphere, cylinder, box) -> a ShapeNet category
# with four parts
OBJECT_CATEGORY = [SHAPENET_CATEGORY_NAMES.index(c)
                   for c in ("Airplane", "Car", "Chair")]
A2D2_SENSORS = 5
SMOOTH = 9
# points per frame at each dataset's real size (the configs' n_pad caps)
REAL_POINTS = {"kitti": (111000, 131072), "nuscenes": (31000, 36864),
               "audi": (33000, 36864), "objects": 2048}


def _frame_points(rng, n_points) -> int:
    lo, hi = n_points
    return int(rng.integers(lo, hi + 1))


def _sweep(rng, n, n_beams, class_of):
    """A sweep in metres -> (pos, reflectance (N,), train ids).  The
    synthetic walls jitter each point's range by up to 3%; a running mean
    of the range over ``SMOOTH`` points along each beam takes most of that
    out, so walls form long curves, as on real scans."""
    from scipy.ndimage import uniform_filter1d

    pos, refl, _, y = lidar_sweep(rng, n, n_beams, len(class_of),
                                  pos_scale=1.0)
    r = np.linalg.norm(pos[:, :2], axis=1).reshape(n_beams, -1)
    scale = (uniform_filter1d(r, SMOOTH, axis=1, mode="nearest")
             / np.maximum(r, 1e-6)).reshape(-1, 1)
    pos[:, :2] *= scale
    pos[:, 2:] = SENSOR_HEIGHT + (pos[:, 2:] - SENSOR_HEIGHT) * scale
    return pos, refl[:, 0], class_of[y].astype(np.int32)


def write_kitti(root: str, frames: Dict[str, int],
                n_points: Tuple[int, int], seed: int = 0) -> str:
    """``frames``: sequence -> frames (e.g. {"00": 4, "08": 2, "11": 2}) ->
    ``root``, the folder that holds ``sequences/``.  Test sequences (11 and
    above) get no labels."""
    rng = np.random.default_rng(seed)
    inv = np.zeros(max(KITTI_LEARNING_MAP_INV) + 1, np.uint32)
    for train_id, raw in KITTI_LEARNING_MAP_INV.items():
        inv[train_id] = raw
    for seq, count in sorted(frames.items()):
        vel = os.path.join(root, "sequences", seq, "velodyne")
        os.makedirs(vel, exist_ok=True)
        for i in range(count):
            pos, refl, y = _sweep(rng, _frame_points(rng, n_points), 64,
                                  KITTI_CLASS_OF)
            np.concatenate([pos, refl[:, None]], 1).astype(
                np.float32).tofile(os.path.join(vel, f"{i:06d}.bin"))
            if int(seq) > 10:
                continue
            inst = np.where(np.isin(y, KITTI_INSTANCE), 1 + y * 37, 0)
            raw = inv[y] | (inst.astype(np.uint32) << 16)
            lab = os.path.join(root, "sequences", seq, "labels")
            os.makedirs(lab, exist_ok=True)
            raw.astype(np.uint32).tofile(os.path.join(lab, f"{i:06d}.label"))
    return root


def write_nuscenes(root: str, frames: Dict[str, int],
                   n_points: Tuple[int, int], seed: int = 0) -> str:
    """``frames``: split -> frames -> ``root`` (samples/, lidarseg/ and the
    info pkls); the sample_data token of frame i of a split names its
    lidarseg file."""
    rng = np.random.default_rng(seed)
    inv = np.zeros(max(NUSCENES_LEARNING_MAP.values()) + 1, np.uint8)
    for raw in sorted(NUSCENES_LEARNING_MAP, reverse=True):
        inv[NUSCENES_LEARNING_MAP[raw]] = raw   # the lowest raw id wins
    lid_dir = os.path.join(root, "samples", "LIDAR_TOP")
    seg_dir = os.path.join(root, "lidarseg", "v1.0-trainval")
    os.makedirs(lid_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)
    for split, count in frames.items():
        infos = []
        for i in range(count):
            pos, refl, y = _sweep(rng, _frame_points(rng, n_points), 32,
                                  NUSCENES_CLASS_OF)
            ring = np.repeat(np.arange(32), len(pos) // 32)
            firing = np.argsort(np.arctan2(pos[:, 1], pos[:, 0]),
                                kind="stable")
            raw = np.concatenate([pos, refl[:, None], ring[:, None]],
                                 1).astype(np.float32)[firing]
            token = f"{seed:04x}{split}{i:06x}"
            fname = f"fake__LIDAR_TOP__{split}{i:04d}.pcd.bin"
            raw.tofile(os.path.join(lid_dir, fname))
            info = {"lidar_path": f"./data/nuscenes/samples/LIDAR_TOP/{fname}",
                    "lidar_token": token}
            if split != "test":
                seg = f"lidarseg/v1.0-trainval/{token}_lidarseg.bin"
                inv[y[firing]].tofile(os.path.join(root, seg))
                info["lidarseg_path"] = seg
            infos.append(info)
        with open(os.path.join(root, f"nuscenes_infos_{split}.pkl"),
                  "wb") as f:
            pickle.dump({"infos": infos, "metadata": {"version": "fake"}}, f)
    return root


def write_a2d2(root: str, frames: Dict[str, int], n_points: Tuple[int, int],
               seed: int = 0) -> str:
    """``frames``: split -> frames -> ``root`` ({split}/*.npz)."""
    rng = np.random.default_rng(seed)
    share = np.array([0.4, 0.15, 0.15, 0.15, 0.15])   # front centre widest
    for split, count in frames.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(count):
            n = _frame_points(rng, n_points)
            parts = []
            for sid in range(A2D2_SENSORS):
                pos, refl, y = _sweep(rng, int(n * share[sid]), 16,
                                      A2D2_CLASS_OF)
                pos[:, :2] += rng.uniform(-1.5, 1.5, 2)   # the mount
                parts.append((pos, refl, np.full(len(pos), sid, np.int64),
                              sid * 10**7 + np.arange(len(pos)), y))
            cols = [np.concatenate(c) for c in zip(*parts)]
            shuffle = rng.permutation(len(cols[0]))
            pos, refl, sid, ts, y = (c[shuffle] for c in cols)
            np.savez(os.path.join(root, split, f"frame{i:05d}.npz"),
                     points=pos.astype(np.float32),
                     reflectance=refl.astype(np.float32), lidar_id=sid,
                     timestamp=ts, labels=y.astype(np.int64))
    return root


def write_objects(root: str, data_generation: dict, frames: Dict[str, int],
                  n_points: int, seed: int = 0) -> str:
    """``frames``: split -> objects -> ``root`` (one ``.pth`` a split)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    names = list(SHAPENET_SEG_CLASSES)
    for split, count in frames.items():
        pos, batch, curves, y, cats = [], [], [], [], []
        offset = 0
        for i in range(count):
            p, c, parts, shape = object_scan(rng, n_points)
            cat = OBJECT_CATEGORY[shape]
            pos.append(p * rng.uniform(0.5, 2.0) + rng.normal(0, 0.3, 3))
            batch.append(np.full(len(p), i))
            curves.append(c.astype(np.int64) + offset)
            offset += int(c.max()) + 1
            y.append(np.asarray(SHAPENET_SEG_CLASSES[names[cat]])[parts])
            cats.append(cat)
        n = sum(len(p) for p in pos)
        blob = types.SimpleNamespace(
            pos=torch.from_numpy(np.concatenate(pos).astype(np.float32)),
            batch=torch.from_numpy(np.concatenate(batch)),
            curve_idxs=torch.from_numpy(np.concatenate(curves)),
            y=torch.from_numpy(np.concatenate(y).astype(np.int64)),
            labels=torch.tensor(cats),
            curvature=torch.from_numpy(
                rng.normal(size=(n, 3)).astype(np.float32)))
        torch.save(blob, os.path.join(
            root, f"{object_stem(data_generation)}_{split}.pth"))
    return root


def write_kortx_raw(root: str, instances: int, n_points: int,
                    seed: int = 0) -> str:
    """A raw Kortx capture directory: per instance ``info.json`` and two
    ``.csv`` views (x, y, z, time, curve, label) plus a background view
    the preprocessor skips -> ``root``."""
    rng = np.random.default_rng(seed)
    for i in range(instances):
        inst = os.path.join(root, f"instance{i:03d}")
        os.makedirs(inst, exist_ok=True)
        with open(os.path.join(inst, "info.json"), "w") as f:
            json.dump({"object-class": CATEGORY_NAMES[(3 * i) % 16],
                       "capture-setting": "table" if i % 2 else "wall"}, f)
        for view in ("view0", "view1", "background"):
            p, c, parts, _ = object_scan(rng, n_points)
            p = p * 150.0                        # millimetres
            c = c.astype(np.int64)
            # single-point curves, which the preprocessor collapses
            for j in rng.choice(np.arange(1, len(c) - 1), 3, replace=False):
                c[j:] += 1
                c[j + 1:] += 1
            t = np.arange(len(p), dtype=np.float64)
            np.savetxt(os.path.join(inst, f"{view}.csv"), np.column_stack(
                [p, t, c, parts]), delimiter=",")
    return root


def write_for_config(cfg: dict, root: str, frames: Dict[str, int],
                     n_points=None, seed: int = 0) -> str:
    """The files that ``main.load_datasets`` reads for ``cfg`` under
    ``root`` -> the ``data_path`` to give it.  ``frames``: split ("train",
    "val", "test") -> frames; ``n_points`` defaults to the real size
    (:data:`REAL_POINTS`)."""
    src = cfg["dataset_source"]
    if src == "kitti":
        seqs = {"train": "00", "val": "08", "test": "11"}
        return write_kitti(root, {seqs[s]: n for s, n in frames.items()},
                           n_points or REAL_POINTS["kitti"], seed)
    if src == "nuscenes":
        return write_nuscenes(root, frames,
                              n_points or REAL_POINTS["nuscenes"], seed)
    if src == "audi":
        return write_a2d2(root, frames, n_points or REAL_POINTS["audi"],
                          seed)
    if src in ("shapenet-seg", "shapenet", "kortx", "summer-robotics"):
        return write_objects(root, cfg.get("data_generation", {}), frames,
                             n_points or REAL_POINTS["objects"], seed)
    raise KeyError(f"no fixture writer for dataset_source {src!r}")
