"""ShapeNetCore v1/v2 directory-layout loader + part-label transfer (a
copy of ``curvecloudnet_tpu/simulator/shapenet_core.py``; NumPy, csv and
SciPy on the host).

Capability parallel of the reference's split-aware dataset shim
(``scanning_simulator/shapenet_seg/shapenet_dataset.py:24-210``) and the
nearest-neighbor part-label transfer in its generator
(``generate_shapenet.py:89-90``) — rebuilt host-side (numpy/scipy) without
the pytorch3d/torch dependencies.

Expected layout (v1): ``data_dir/<synset_offset>/<model_id>/model.obj``;
(v2): ``.../<model_id>/models/model_normalized.obj``.  Official splits come
from the ShapeNet ``all.csv`` (columns incl. ``synsetId``, ``modelId``,
``split``).  Part labels (when available) follow the ShapeNet part-seg
layout: ``labels_dir/<synset>/points/<model_id>.pts`` +
``labels_dir/<synset>/points_label/<model_id>.seg``.
"""

from __future__ import annotations

import csv
import os
import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ShapeNetModel:
    synset: str
    model_id: str
    obj_path: str
    label_pts_path: Optional[str] = None
    label_seg_path: Optional[str] = None


class ShapeNetCoreSplit:
    """Walks a ShapeNetCore tree, optionally filtered by synsets and the
    official split CSV (reference shapenet_dataset.py:104-133)."""

    def __init__(self, data_dir: str, version: int = 1,
                 synsets: Optional[Sequence[str]] = None,
                 split: str = "train", split_csv_path: str = "",
                 labels_dir: str = ""):
        if version not in (1, 2):
            raise ValueError("version must be 1 or 2")
        self.data_dir = data_dir
        self.model_rel = ("model.obj" if version == 1
                          else os.path.join("models", "model_normalized.obj"))
        present = {d for d in os.listdir(data_dir)
                   if os.path.isdir(os.path.join(data_dir, d))}
        if synsets:
            chosen = set()
            for s in synsets:
                if s in present:
                    chosen.add(s)
                else:
                    warnings.warn(f"synset {s!r} not found in {data_dir}")
        else:
            chosen = present

        split_ids = None
        if split_csv_path:
            split_ids = set()
            with open(split_csv_path, newline="") as f:
                for row in csv.DictReader(f):
                    if row.get("split") == split:
                        split_ids.add(row["modelId"])

        self.models: List[ShapeNetModel] = []
        for synset in sorted(chosen):
            sdir = os.path.join(data_dir, synset)
            for model_id in sorted(os.listdir(sdir)):
                mdir = os.path.join(sdir, model_id)
                obj = os.path.join(mdir, self.model_rel)
                if not os.path.isdir(mdir) or not os.path.exists(obj):
                    continue
                if split_ids is not None and model_id not in split_ids:
                    continue
                pts = seg = None
                if labels_dir:
                    p = os.path.join(labels_dir, synset, "points",
                                     model_id + ".pts")
                    s = os.path.join(labels_dir, synset, "points_label",
                                     model_id + ".seg")
                    if os.path.exists(p) and os.path.exists(s):
                        pts, seg = p, s
                self.models.append(ShapeNetModel(synset, model_id, obj,
                                                 pts, seg))

    def __len__(self) -> int:
        return len(self.models)

    def __iter__(self) -> Iterator[ShapeNetModel]:
        return iter(self.models)


def load_part_labels(model: ShapeNetModel
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The part-seg point cloud + per-point labels for a model, if any."""
    if not model.label_pts_path:
        return None
    pts = np.loadtxt(model.label_pts_path, dtype=np.float32)
    seg = np.loadtxt(model.label_seg_path, dtype=np.int64)
    if pts.ndim == 1:
        pts = pts[None]
        seg = np.atleast_1d(seg)
    return pts.reshape(-1, 3), seg.reshape(-1)


def transfer_part_labels(scan_pos: np.ndarray, label_pos: np.ndarray,
                         labels: np.ndarray) -> np.ndarray:
    """Nearest-neighbor label transfer (reference generate_shapenet.py:89-90
    uses ``argmin(cdist(scan, labeled))``)."""
    try:
        from scipy.spatial import cKDTree

        _, idx = cKDTree(label_pos).query(scan_pos, k=1)
    except ImportError:  # tiled exact fallback
        idx = np.empty(len(scan_pos), np.int64)
        for s in range(0, len(scan_pos), 4096):
            d = np.linalg.norm(
                scan_pos[s:s + 4096, None, :] - label_pos[None], axis=-1)
            idx[s:s + 4096] = np.argmin(d, axis=1)
    return np.asarray(labels)[idx]
