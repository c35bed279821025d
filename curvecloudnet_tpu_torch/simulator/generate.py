"""Mesh → curve-cloud dataset generation (the simulator's entry, stage 4;
counterpart of ``curvecloudnet_tpu/simulator/generate.py``).

Host and card split the work: the rasterizer (kernel K11), the
anti-aliasing filter and the curvature run on ``device`` (default
``cuda``; ``"cpu"`` runs their plain versions); scan lines, the camera
transforms, part-label transfer (``cKDTree``) and ``np.savez_compressed``
run on the host, as the JAX package runs them.  A scan's rasterized mask
crosses to the host once, its points and normals once, and its smoothed
points once.

Parallel of the reference generators (``scanning_simulator/shapenet_seg/
generate_shapenet.py``, ``kortx/generate_shapenet.py``): rasterize a mesh
from a camera, sample scan lines over the image plane, lift to 3D curve
clouds, anti-alias, estimate curvature, transfer part labels by nearest
vertex, and write padded ``.npz`` shards consumed by the data layer.

Mesh sources: Wavefront OBJ files when available, else procedural primitives
(this environment has no ShapeNet download).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import curve_cloud as cc
from . import rasterizer, scanlines
from .rasterizer import Pinhole, look_at_camera


# ---------------------------------------------------------------------------
# Mesh sources
# ---------------------------------------------------------------------------

def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def uv_sphere(n_lat=32, n_lon=48, radius=0.5):
    lat = np.linspace(0, np.pi, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts = []
    for la in lat:
        for lo in lon:
            verts.append([radius * np.sin(la) * np.cos(lo),
                          radius * np.cos(la),
                          radius * np.sin(la) * np.sin(lo)])
    verts = np.asarray(verts, np.float32)
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    return verts, np.asarray(faces, np.int32)


def box(size=(0.6, 0.4, 0.5)):
    sx, sy, sz = np.asarray(size) / 2
    v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                  for z in (-sz, sz)], np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.int32)
    return v, f


def cylinder(radius=0.3, height=0.8, n=48):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    top = np.stack([radius * np.cos(ang), np.full(n, height / 2),
                    radius * np.sin(ang)], -1)
    bot = top.copy()
    bot[:, 1] = -height / 2
    verts = np.concatenate([top, bot,
                            [[0, height / 2, 0]], [[0, -height / 2, 0]]])
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + i], [j, n + j, n + i]]       # side
        faces += [[2 * n, j, i], [2 * n + 1, n + i, n + j]]  # caps
    return verts.astype(np.float32), np.asarray(faces, np.int32)


PRIMITIVES = {"sphere": uv_sphere, "box": box, "cylinder": cylinder}


def part_labels_by_height(verts: np.ndarray, n_parts: int = 4) -> np.ndarray:
    """Simple vertex part labels: height quantiles (stand-in for ShapeNet
    part annotations when real labels are unavailable)."""
    y = verts[:, 1]
    edges = np.quantile(y, np.linspace(0, 1, n_parts + 1)[1:-1])
    return np.digitize(y, edges).astype(np.int32)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

def mesh_to_curve_cloud(rng: np.random.Generator, verts: np.ndarray,
                        faces: np.ndarray, vert_labels: Optional[np.ndarray],
                        n_points: int = 2048, resolution: int = 512,
                        pattern: str = "random", density: float = 0.25,
                        antialias: bool = True, with_curvature: bool = False,
                        random_so3: bool = False, device=None):
    """One scan: mesh -> (pos, curve_id, labels[, curvature]), NumPy arrays.

    Mirrors SampleMeshes.meshes2points (sampling.py:43-86) + label transfer
    (generate_shapenet.py:89-90).  ``device``: where the rasterizer, the
    filter and the curvature run (default ``cuda``).
    """
    device = rasterizer.checked_device(device)
    # normalize mesh to unit sphere, random camera
    verts = verts - verts.mean(0, keepdims=True)
    verts = verts / max(np.linalg.norm(verts, axis=1).max(), 1e-8)
    so3_q = None
    if random_so3:
        # random SO(3) orientation (reference kortx/generate_shapenet.py:68-99)
        A = rng.normal(size=(3, 3))
        q, r = np.linalg.qr(A)
        q *= np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        verts = verts @ q.T
        so3_q = q
    cam_verts, cam_rot, cam_eye = look_at_camera(
        verts, distance=2.2,
        elev_deg=float(rng.uniform(-30, 45)),
        azim_deg=float(rng.uniform(0, 360)),
        return_transform=True)
    f = resolution * 1.8
    pin = Pinhole(fx=f, fy=f, cx=resolution / 2, cy=resolution / 2,
                  h=resolution, w=resolution)
    coords, normals, mask = rasterizer.rasterize(cam_verts, faces, pin,
                                                 device)
    got = scanlines.generate_scan_lines(rng, mask.cpu().numpy(), n_points,
                                        pattern=pattern, density=density)
    if got is None:
        return None
    uv, cid = got
    uv_d = torch.as_tensor(uv, device=device)
    pos_d = coords[uv_d[:, 0], uv_d[:, 1]]
    pos, nrm = (t.cpu().numpy() for t in torch.stack(
        [pos_d, normals[uv_d[:, 0], uv_d[:, 1]]]))
    cid = cc.split_curves_3d(pos, cid)
    cid_d = torch.as_tensor(cid, device=device)[None]
    valid_d = torch.ones((1, len(pos)), dtype=torch.bool, device=device)

    if antialias:
        pos_d = cc.anti_alias(pos_d[None], cid_d, valid_d)[0]
        pos = pos_d.cpu().numpy()

    # object-space coordinates of the scan points (camera inverse, then
    # the SO3 inverse): part-label transfer must match frames — the label
    # cloud lives in the normalized OBJECT frame
    pos_obj = pos @ cam_rot + cam_eye
    if so3_q is not None:
        pos_obj = pos_obj @ so3_q

    labels = None
    if vert_labels is not None:
        # nearest-vertex label transfer (object frame, cKDTree — the
        # dense (n_points, n_verts) distance matrix blows memory on real
        # ShapeNetCore meshes)
        from scipy.spatial import cKDTree

        obj_verts = verts if so3_q is None else verts @ so3_q
        _, nn = cKDTree(obj_verts).query(pos_obj, k=1)
        labels = vert_labels[nn]

    out = dict(pos=pos.astype(np.float32), curve_id=cid,
               pos_obj=pos_obj.astype(np.float32),
               normals=nrm.astype(np.float32), labels=labels)
    if with_curvature:
        curv, _ = cc.estimate_curvature_and_grads(pos_d[None], None, cid_d,
                                                  valid_d)
        out["curvature"] = curv[0].cpu().numpy().astype(np.float32)
    return out


def generate_dataset(outdir: str, n_samples: int = 64, n_points: int = 2048,
                     resolution: int = 512, pattern: str = "random",
                     density: float = 0.25, n_parts: int = 4,
                     seed: int = 0, obj_dir: Optional[str] = None,
                     shapenet_dir: Optional[str] = None,
                     shapenet_version: int = 1,
                     split: str = "train", split_csv: str = "",
                     labels_dir: str = "", synsets=None,
                     random_so3: bool = False,
                     viz_every: int = 0, viz_dir: Optional[str] = None,
                     device=None) -> str:
    """Write a padded .npz dataset of simulated scans (one file per split
    shard).

    Mesh sources, in priority order: a real ShapeNetCore tree
    (``shapenet_dir`` + optional official ``split_csv`` + part-seg
    ``labels_dir`` for NN label transfer, reference
    generate_shapenet.py:47-110), a flat OBJ directory, or procedural
    primitives with height-quantile stand-in labels.  ``device``: where
    the rasterizer and the filter run (default ``cuda``; a missing card
    raises)."""
    device = rasterizer.checked_device(device)
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = sorted(PRIMITIVES)
    objs = (sorted(os.path.join(obj_dir, p) for p in os.listdir(obj_dir)
                   if p.endswith(".obj")) if obj_dir else [])
    snc = None
    if shapenet_dir:
        from .shapenet_core import (
            ShapeNetCoreSplit, load_part_labels, transfer_part_labels,
        )

        snc = ShapeNetCoreSplit(shapenet_dir, version=shapenet_version,
                                synsets=synsets, split=split,
                                split_csv_path=split_csv,
                                labels_dir=labels_dir)
        if not len(snc):
            raise FileNotFoundError(
                f"no ShapeNetCore models under {shapenet_dir} for "
                f"split={split!r}")
        # category ids from the FULL synset universe (the explicit
        # ``synsets`` list or the directory listing), never the split's
        # surviving subset — per-split id assignment would let train and
        # val shards disagree about which class is which
        if synsets:
            synset_ids = sorted(synsets)
        else:
            synset_ids = sorted(
                d for d in os.listdir(shapenet_dir)
                if os.path.isdir(os.path.join(shapenet_dir, d)))
            if not synset_ids:
                synset_ids = sorted({m.synset for m in snc})
    pos_all = np.zeros((n_samples, n_points, 3), np.float32)
    cid_all = np.zeros((n_samples, n_points), np.int32)
    lab_all = np.zeros((n_samples, n_points), np.int32)
    cat_all = np.zeros((n_samples,), np.int32)
    valid_all = np.zeros((n_samples, n_points), bool)
    i = 0
    while i < n_samples:
        label_cloud = None
        if snc is not None:
            model = snc.models[int(rng.integers(len(snc)))]
            verts, faces = load_obj(model.obj_path)
            cat = synset_ids.index(model.synset)
            label_cloud = load_part_labels(model)
        elif objs:
            cat = int(rng.integers(len(objs)))
            verts, faces = load_obj(objs[cat])
        else:
            cat = int(rng.integers(len(names)))
            verts, faces = PRIMITIVES[names[cat]]()
        # skip the stand-in height labels when real part labels will
        # overwrite them (the vertex transfer is pure wasted work there)
        vl = (None if label_cloud is not None
              else part_labels_by_height(verts, n_parts))
        got = mesh_to_curve_cloud(rng, verts, faces, vl, n_points,
                                  resolution, pattern, density,
                                  random_so3=random_so3, device=device)
        if got is None:
            continue
        m = len(got["pos"])
        if label_cloud is not None:
            # real part labels: nearest-neighbor transfer from the
            # part-seg point cloud, matched in the OBJECT frame (the scan
            # points are camera-frame; pos_obj is their object-space map)
            lp, ly = label_cloud
            lp = lp - lp.mean(0, keepdims=True)
            lp = lp / max(np.linalg.norm(lp, axis=1).max(), 1e-8)
            got["labels"] = transfer_part_labels(got["pos_obj"], lp, ly)
        pos_all[i, :m] = got["pos"]
        cid_all[i, :m] = got["curve_id"]
        lab_all[i, :m] = got["labels"][:m]
        valid_all[i, :m] = True
        cat_all[i] = cat
        if viz_every and i % viz_every == 0:
            # generation-time QA renders (reference
            # scanning_simulator/utils/visualization.py:10-153)
            from .qa_viz import write_qa_panels

            lp = ly = None
            if label_cloud is not None:
                lp, ly = label_cloud
                lp = lp - lp.mean(0, keepdims=True)
                lp = lp / max(np.linalg.norm(lp, axis=1).max(), 1e-8)
            write_qa_panels(viz_dir or os.path.join(outdir, "qa"), i,
                            got["pos_obj"], got["curve_id"], got["labels"],
                            lp, ly)
        i += 1
    path = os.path.join(
        outdir, f"sim_{n_points}_{resolution}_{density}_{pattern}.npz")
    np.savez_compressed(path, pos=pos_all, curve_id=cid_all, labels=lab_all,
                        category=cat_all, valid=valid_all)
    return path
