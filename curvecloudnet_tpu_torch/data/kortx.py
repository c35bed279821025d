"""Kortx structured-light scan preprocessing and dataset (counterpart of
``curvecloudnet_tpu/data/kortx.py``).

After the reference's Kortx generator (``scanning_simulator/kortx/
generate_kortx.py:20-135``): raw per-view CSV scans (x, y, z, time, curve,
label) are windowed into ``samples_per_scan`` clips of ``n_points``, curve
indices are repaired (degenerate single-point curves collapsed) and cut at
large 3D gaps, each clip is scale-normalized, and everything is written as
one padded ``.npz`` shard that :class:`KortxNpzDataset` serves.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .datasets import CurveDataset, Sample

# The fixed 16-class ShapeNet category mapping (reference
# generate_kortx.py:13-15): Kortx captures take the ids the ShapeNet-trained
# category head was trained with.  Classes outside this list append after
# 15, with a warning.
CATEGORY_NAMES = ['airplane', 'bag', 'cap', 'car', 'chair', 'earphone',
                  'guitar', 'knife', 'lamp', 'laptop', 'motorbike', 'mug',
                  'pistol', 'rocket', 'skateboard', 'table']
LABEL_IDS = {name: i for i, name in enumerate(CATEGORY_NAMES)}


def fix_curve_idxs(curve_idxs: np.ndarray) -> np.ndarray:
    """Collapse degenerate adjacent curve starts (reference :92-104)."""
    starts = np.concatenate([[True], np.diff(curve_idxs) > 0])
    adjacent = np.where(starts[:-1] & starts[1:])[0]
    starts[adjacent] = False
    return np.cumsum(starts)


def cut_curves(curve_idxs: np.ndarray, pos: np.ndarray,
               thresh: float = 0.01) -> np.ndarray:
    """Split curves at 3D gaps > thresh (reference :107-118)."""
    edge_lens = np.linalg.norm(np.diff(pos, axis=0), axis=1)
    splits = (np.diff(curve_idxs) > 0) | (edge_lens > thresh)
    return np.concatenate([[0], np.cumsum(splits)]).astype(np.int64)


def preprocess_kortx(data_path: str, outdir: str, n_points: int = 2048,
                     samples_per_scan: int = 5) -> str:
    """Raw Kortx capture directory (one folder an instance: ``info.json``
    with ``object-class`` and ``capture-setting``, and ``.csv`` views) ->
    the path of the padded ``kortx_{n_points}_test.npz`` shard."""
    pos_l, cid_l, seg_l, lab_l = [], [], [], []
    label_ids = dict(LABEL_IDS)
    for instance_id in sorted(os.listdir(data_path)):
        inst = os.path.join(data_path, instance_id)
        info_p = os.path.join(inst, "info.json")
        if not os.path.isfile(info_p):
            continue
        with open(info_p) as f:
            info = json.load(f)
        cls = info["object-class"]
        if cls not in label_ids:
            print(f"[kortx] WARNING: class {cls!r} outside the fixed "
                  f"ShapeNet-16 mapping; appending id {len(label_ids)}")
            label_ids[cls] = len(label_ids)
        capture = info.get("capture-setting", "table")
        for fname in sorted(os.listdir(inst)):
            if not fname.endswith(".csv") or "background" in fname:
                continue
            raw = np.loadtxt(os.path.join(inst, fname), delimiter=",")
            pts, cid = raw[:, :3], raw[:, 4].astype(np.int64)
            seg = raw[:, 5].astype(np.int64)
            cid = fix_curve_idxs(cid)
            cid = cut_curves(cid, pts,
                             thresh=0.2 if capture == "table" else 1.0)
            total = len(pts)
            interval = max(1, (total - n_points) // samples_per_scan)
            for s in range(samples_per_scan):
                lo = s * interval
                sl = slice(lo, lo + n_points)
                p = pts[sl].astype(np.float32)
                p = p / max(np.abs(p).max() * 2, 1e-8)
                c = np.unique(cid[sl], return_inverse=True)[1]
                pos_l.append(p)
                cid_l.append(c.astype(np.int32))
                seg_l.append(seg[sl].astype(np.int32))
                lab_l.append(label_ids[cls])
    os.makedirs(outdir, exist_ok=True)
    m = len(pos_l)
    pos = np.zeros((m, n_points, 3), np.float32)
    cid = np.zeros((m, n_points), np.int32)
    seg = np.zeros((m, n_points), np.int32)
    valid = np.zeros((m, n_points), bool)
    for i in range(m):
        k = len(pos_l[i])
        pos[i, :k], cid[i, :k], seg[i, :k] = pos_l[i], cid_l[i], seg_l[i]
        valid[i, :k] = True
    out = os.path.join(outdir, f"kortx_{n_points}_test.npz")
    np.savez_compressed(out, pos=pos, curve_id=cid, labels=seg,
                        category=np.asarray(lab_l, np.int32), valid=valid)
    return out


class KortxNpzDataset(CurveDataset):
    """A padded ``.npz`` shard (:func:`preprocess_kortx`'s output)."""

    def __init__(self, path: str, task: str = "segmentation",
                 n_classes: int = 50):
        with np.load(path) as blob:
            self._pos = blob["pos"]
            self._cid = blob["curve_id"]
            self._labels = blob["labels"]
            self._cats = blob["category"]
            self._valid = blob["valid"]
        self.n_pad = self._pos.shape[1]
        self.in_dim = 3
        self.task = task
        self.n_classes = n_classes
        self.ignore_index = None

    def __len__(self):
        return len(self._pos)

    def get(self, idx, rng=None, augment=False):
        v = self._valid[idx]
        n = int(v.sum())
        labels = (np.int32(self._cats[idx]) if self.task == "classification"
                  else self._labels[idx][:n])
        return Sample(pos=self._pos[idx][:n], curve_id=self._cid[idx][:n],
                      feat=None, labels=labels,
                      category=int(self._cats[idx]))
