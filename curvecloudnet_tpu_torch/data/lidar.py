"""Lidar datasets: SemanticKITTI, nuScenes-lidarseg and A2D2 readers with
curve extraction and PolarMix (counterpart of
``curvecloudnet_tpu/data/lidar.py``).

Host-side NumPy / SciPy preprocessing emitting curve-cloud samples, the
same arithmetic in the same order as the JAX package, so one file and one
``np.random.Generator`` give both packages the same sample, bit for bit.
The curve extraction follows the reference:

  * sequential split (SemanticKITTI): one acquisition-ordered beam, split
    where edge length > thresh·sqrt(xy-radius)   (kitti_dataset.py:73-92)
  * beam-sorted split (nuScenes): stable-sort by ring index, split at ring
    changes OR range-adaptive discontinuity, keep the inverse permutation
    for submission files                         (nuscenes_dataset.py:91-118)
  * kNN connected components (A2D2, no per-beam order): per-sensor kNN
    graph filtered by range-adaptive edge length, connected components =
    curves, (curve, timestamp) lexsort, re-split  (audi_dataset.py:156-243)

PolarMix (Xiao et al. 2022) scene mixing is curve-aware
(data_utils.py:30-85): curve ids ride along as a channel and are re-offset.

Layouts on disk (``data_path`` of the config):

  * SemanticKITTI: ``data_path/sequences/XX/velodyne/*.bin`` (float32 x, y,
    z, reflectance) and ``labels/*.label`` (uint32, semantic id in the low
    16 bits); train 00-07, 09, 10, val 08, test 11-21;
  * nuScenes: ``nuscenes_infos_{split}.pkl`` (preferred), the devkit, or
    ``samples/LIDAR_TOP/*.pcd.bin`` (5 float32 channels, ring index in
    channel 4) with ``lidarseg/**/*_lidarseg.bin`` (uint8);
  * A2D2: ``data_path/{train,val}/*.npz`` with points / reflectance /
    lidar_id / timestamp / labels (``tools/preprocess_a2d2.py``'s output).

A split that finds no frame raises, naming the glob it tried (the JAX
package yields an empty split there).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from .datasets import CurveDataset, Sample, _lidar_augment

# Standard SemanticKITTI raw-label -> train-id learning map (public metadata,
# semantic-kitti.yaml).  0 = unlabeled/ignore.
KITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}
# nuScenes raw (32 classes) -> lidarseg train ids (16 + noise), public map.
NUSCENES_LEARNING_MAP = {
    0: 0, 1: 0, 2: 7, 3: 7, 4: 7, 5: 0, 6: 7, 7: 0, 8: 0, 9: 1, 10: 0,
    11: 0, 12: 8, 13: 0, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 19: 0, 20: 0,
    21: 6, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 29: 0,
    30: 16, 31: 0,
}

KITTI_INSTANCE_CLASSES = [1, 2, 3, 4, 5, 6, 7, 8]
NUSCENES_INSTANCE_CLASSES = [2, 3, 4, 5, 6, 7, 9, 10]


def _map_labels(raw: np.ndarray, mapping: dict) -> np.ndarray:
    lut = np.zeros(max(mapping) + 1, np.int32)
    for k, v in mapping.items():
        lut[k] = v
    return lut[np.clip(raw, 0, len(lut) - 1)]


# ---------------------------------------------------------------------------
# Curve extraction
# ---------------------------------------------------------------------------

def split_discontinuities(points: np.ndarray, thresh: float,
                          extra_splits: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """Range-adaptive sequential curve split -> nondecreasing curve ids."""
    edges = np.linalg.norm(np.diff(points.astype(np.float64), axis=0), axis=1)
    radii = np.linalg.norm(points[1:, :2], axis=1)
    splits = edges > thresh * np.sqrt(np.maximum(radii, 0))
    if extra_splits is not None:
        splits = splits | extra_splits
    cid = np.concatenate([[0], np.cumsum(splits)])
    return cid.astype(np.int32)


def extract_curves_sequential(points: np.ndarray,
                              thresh: float = 0.08) -> np.ndarray:
    """KITTI: single sequential beam."""
    return split_discontinuities(points, thresh)


def extract_curves_beams(points: np.ndarray, beam_idxs: np.ndarray,
                         thresh: float = 0.08):
    """nuScenes: stable-sort by beam, split at beam change or discontinuity.

    Returns (reorder, inv_reorder, curve_ids) — curve ids are for the
    reordered points.
    """
    reorder = np.argsort(beam_idxs, kind="stable")
    inv = np.empty_like(reorder)
    inv[reorder] = np.arange(len(reorder))
    p = points[reorder]
    b = beam_idxs[reorder]
    beam_change = b[1:] != b[:-1]
    cid = split_discontinuities(p, thresh, extra_splits=beam_change)
    return reorder, inv, cid


def partition_at_discontinuities(points: np.ndarray, curve_idxs: np.ndarray,
                                 thresh: float) -> np.ndarray:
    """A2D2 re-split: break where BOTH the 1- and 2-step edges exceed the
    range-adaptive threshold, or at existing curve changes
    (audi_dataset.py:221-243)."""

    def edge_lens(spacing):
        e = np.linalg.norm(
            points[spacing:].astype(np.float64) - points[:-spacing], axis=1)
        return np.concatenate([np.full(spacing, 10.0), e])

    e1, e2 = edge_lens(1), edge_lens(2)
    sq_r = np.sqrt(np.linalg.norm(points[:, :2], axis=1))
    splits3d = (e1 > thresh * sq_r) & (e2 > thresh * sq_r)
    changes = np.concatenate([[False], curve_idxs[1:] != curve_idxs[:-1]])
    return np.cumsum(splits3d | changes).astype(np.int32) - 1


def extract_curves_knn(points: np.ndarray, timestamps: np.ndarray,
                       k: int = 4, thresh: float = 0.1):
    """A2D2: kNN graph -> range-filtered edges -> connected components ->
    (component, timestamp) lexsort -> re-split.  Returns (reorder, cid)."""
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    n = len(points)
    if n <= 1:
        return np.arange(n), np.zeros(n, np.int32)
    tree = cKDTree(points)
    dist, nbr = tree.query(points, k=min(k, n))
    src = np.repeat(np.arange(n), nbr.shape[1])
    dst = nbr.reshape(-1)
    lens = dist.reshape(-1)
    sq_r = np.sqrt(np.linalg.norm(points[:, :2], axis=1))
    keep = lens < thresh * sq_r[src]
    adj = sp.coo_matrix(
        (np.ones(keep.sum()), (src[keep], dst[keep])), shape=(n, n))
    _, comp = sp.csgraph.connected_components(adj)
    reorder = np.lexsort((timestamps.reshape(-1), comp))
    cid = partition_at_discontinuities(points[reorder], comp[reorder],
                                       0.9 * thresh)
    return reorder, cid.astype(np.int32)


# ---------------------------------------------------------------------------
# PolarMix (curve-aware scene mixing)
# ---------------------------------------------------------------------------

def polarmix(rng: np.random.Generator, pts1, labels1, pts2, labels2,
             instance_classes) -> Tuple[np.ndarray, np.ndarray]:
    """Curve-aware PolarMix.  ``pts*`` are (N, 5): xyz, reflectance, curve_id
    (curve id as a data channel, exactly the reference's trick,
    kitti_dataset.py:100-103).  Returns mixed (pts, labels)."""
    alpha = (rng.random() - 1) * np.pi
    beta = alpha + np.pi
    out_p, out_y = pts1, labels1

    if rng.random() < 0.5:  # azimuth-sector swap
        yaw1 = -np.arctan2(pts1[:, 1], pts1[:, 0])
        yaw2 = -np.arctan2(pts2[:, 1], pts2[:, 0])
        keep1 = ~((yaw1 > alpha) & (yaw1 < beta))
        take2 = (yaw2 > alpha) & (yaw2 < beta)
        out_p = np.concatenate([pts1[keep1], pts2[take2]])
        out_y = np.concatenate([labels1[keep1], labels2[take2]])

    if rng.random() < 0.5:  # rotate-paste of instance classes
        omegas = [rng.random() * np.pi * 2 / 3,
                  (rng.random() + 1) * np.pi * 2 / 3]
        inst = np.isin(labels2, instance_classes)
        p_inst, y_inst = pts2[inst], labels2[inst]
        order = np.argsort(p_inst[:, 4], kind="stable")
        p_inst, y_inst = p_inst[order], y_inst[order]
        copies, labels_c = [p_inst], [y_inst]
        for om in omegas:
            c, s = np.cos(om), np.sin(om)
            rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
            q = p_inst.copy()
            q[:, :3] = p_inst[:, :3] @ rot
            if len(q):
                q[:, 4] = p_inst[:, 4] + copies[-1][:, 4].max() + 1
            copies.append(q)
            labels_c.append(y_inst)
        pasted = np.concatenate(copies)
        if len(pasted) and len(out_p):
            pasted[:, 4] += out_p[:, 4].max() + 1
        out_p = np.concatenate([out_p, pasted])
        out_y = np.concatenate([out_y, np.concatenate(labels_c)])

    # densify curve ids (stable scan order within curves is preserved
    # because concatenation kept per-curve contiguity)
    _, cid = np.unique(out_p[:, 4], return_inverse=True)
    order = np.argsort(cid, kind="stable")
    out_p, out_y, cid = out_p[order], out_y[order], cid[order]
    out_p[:, 4] = cid
    return out_p, out_y


# ---------------------------------------------------------------------------
# Dataset classes
# ---------------------------------------------------------------------------

def _no_frame(dataset: str, split: str, pattern: str):
    """A split of a real dataset that finds no frame raises (an empty epoch
    would run no step without a word)."""
    raise FileNotFoundError(
        f"{dataset} {split} split: no frame matches {pattern}")


class SemKITTI(CurveDataset):
    """SemanticKITTI lidarseg (reference kitti_dataset.py).

    data_path/sequences/XX/velodyne/*.bin (+ labels/*.label)."""

    TRAIN_SEQS = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
    VAL_SEQS = ["08"]
    TEST_SEQS = ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20",
                 "21"]

    def __init__(self, data_path: str, split: str = "train",
                 n_pad: int = 131072, polarmix_aug: bool = True,
                 curve_thresh: float = 0.08, pos_normalize: float = 20.0):
        seqs = {"train": self.TRAIN_SEQS, "val": self.VAL_SEQS,
                "test": self.TEST_SEQS}[split]
        self.fpaths = sorted(
            p for s in seqs for p in glob.glob(
                os.path.join(data_path, "sequences", s, "velodyne", "*.bin")))
        if not self.fpaths:
            _no_frame("SemanticKITTI", split, os.path.join(
                data_path, "sequences", "{" + ",".join(seqs) + "}",
                "velodyne", "*.bin"))
        self.split = split
        self.n_pad = n_pad
        self.in_dim = 4
        self.n_classes = 20
        self.task = "segmentation"
        self.ignore_index = 0
        self.polarmix_aug = polarmix_aug
        self.curve_thresh = curve_thresh
        self.pos_normalize = pos_normalize

    def __len__(self):
        return len(self.fpaths)

    def _load_frame(self, idx):
        raw = np.fromfile(self.fpaths[idx], np.float32).reshape(-1, 4)
        if self.split == "test":
            labels = np.zeros(len(raw), np.int32)
        else:
            lp = self.fpaths[idx].replace("velodyne", "labels")[:-3] + "label"
            ann = np.fromfile(lp, np.int32) & 0xFFFF
            labels = _map_labels(ann, KITTI_LEARNING_MAP)
        return raw[:, :3], labels, raw[:, 3:4]

    def get(self, idx, rng=None, augment=False):
        pts, labels, refl = self._load_frame(idx)
        cid = extract_curves_sequential(pts, self.curve_thresh)
        if augment and rng is not None and self.polarmix_aug:
            j = int(rng.integers(len(self.fpaths)))
            p2, y2, r2 = self._load_frame(j)
            c2 = extract_curves_sequential(p2, self.curve_thresh)
            pk1 = np.concatenate([pts, refl, (cid)[:, None]], 1)
            pk2 = np.concatenate(
                [p2, r2, (c2 + cid.max() + 1)[:, None]], 1)
            mixed, labels = polarmix(rng, pk1, labels, pk2, y2,
                                     KITTI_INSTANCE_CLASSES)
            pts, refl, cid = mixed[:, :3], mixed[:, 3:4], mixed[:, 4].astype(
                np.int32)
        if augment and rng is not None:
            pts = _lidar_augment(pts.astype(np.float32), rng)
        pts = pts / self.pos_normalize
        return Sample(pos=pts.astype(np.float32), curve_id=cid,
                      feat=refl.astype(np.float32),
                      labels=labels.astype(np.int32),
                      meta={"fpath": self.fpaths[idx], "format": "kitti"})


class SemNuScenes(CurveDataset):
    """nuScenes lidarseg (reference nuscenes_dataset.py).

    Reads the raw .pcd.bin five-channel point files + lidarseg label bins via
    an index built from the devkit when available, else a directory glob
    pairing ``samples/LIDAR_TOP/*.pcd.bin`` with ``lidarseg/**/*.bin``."""

    def __init__(self, data_path: str, split: str = "train",
                 n_pad: int = 65536, polarmix_aug: bool = True,
                 curve_thresh: float = 0.08, pos_normalize: float = 20.0):
        self.data_path = data_path
        self.split = split
        self.n_pad = n_pad
        self.in_dim = 4
        self.n_classes = 17
        self.task = "segmentation"
        self.ignore_index = 0
        self.polarmix_aug = polarmix_aug
        self.curve_thresh = curve_thresh
        self.pos_normalize = pos_normalize
        self.pairs = self._build_index()
        if not self.pairs:
            _no_frame("nuScenes", split, " or ".join((
                os.path.join(data_path, f"nuscenes_infos_{split}.pkl"),
                os.path.join(data_path, "samples", "LIDAR_TOP",
                             "*.pcd.bin"))))

    def _build_index(self):
        import pickle

        # preferred: the reference's nuscenes_infos_{split}.pkl index
        # (nuscenes_dataset.py:66-74) — works without the devkit
        pkl = os.path.join(self.data_path,
                           f"nuscenes_infos_{self.split}.pkl")
        if os.path.exists(pkl):
            with open(pkl, "rb") as f:
                infos = pickle.load(f)
            if isinstance(infos, dict):
                infos = infos.get("infos", infos)
            pairs = []
            for info in infos:
                lp = os.path.join(self.data_path,
                                  *info["lidar_path"].split("/")[-3:])
                seg = info.get("lidarseg_path")
                if seg:
                    seg = os.path.join(self.data_path, seg)
                # the sample_data token names the official submission file
                # (reference nuscenes_dataset.py:85: token + '_lidarseg.bin')
                tok = (info.get("lidar_token")
                       or info.get("lidar_sd_token"))
                pairs.append((lp, seg, tok))
            # the TEST split legitimately carries no lidarseg paths — its
            # correctly-scoped frame list must not be discarded for the
            # unsplit fallbacks below
            if pairs and (self.split == "test"
                          or any(p[1] for p in pairs)):
                return pairs
            # fall through to devkit/glob to resolve seg files
        try:
            from nuscenes import NuScenes  # optional devkit

            version = ("v1.0-test" if self.split == "test"
                       else "v1.0-trainval")
            nusc = NuScenes(version=version, dataroot=self.data_path,
                            verbose=False)
            # official scene splits — without this filter train and val
            # would serve the SAME frames (total train/val leak)
            from nuscenes.utils.splits import create_splits_scenes

            scene_names = set(create_splits_scenes()[self.split])
            scene_ok = {s["token"] for s in nusc.scene
                        if s["name"] in scene_names}
            pairs = []
            for sample in nusc.sample:
                if sample["scene_token"] not in scene_ok:
                    continue
                tok = sample["data"]["LIDAR_TOP"]
                sd = nusc.get("sample_data", tok)
                lp = os.path.join(self.data_path, sd["filename"])
                if self.split == "test":
                    pairs.append((lp, None, tok))
                else:
                    seg = nusc.get("lidarseg", tok)["filename"]
                    pairs.append((lp, os.path.join(self.data_path, seg),
                                  tok))
            return pairs
        except Exception:
            # last-resort glob: lidarseg files are named
            # <sample_data_token>_lidarseg.bin — that token is NOT
            # derivable from the .pcd.bin filename, so label pairing only
            # works for exports that place '<pcd_stem>_lidarseg.bin' next
            # to the sweeps.  Frames without a match get zero labels and
            # a LOUD warning (previous behavior paired by an impossible
            # key and silently zeroed every frame).
            lid = sorted(glob.glob(os.path.join(
                self.data_path, "samples", "LIDAR_TOP", "*.pcd.bin")))
            seg_dir = os.path.join(self.data_path, "lidarseg")
            segs = {os.path.basename(p): p
                    for p in glob.glob(os.path.join(seg_dir, "**", "*.bin"),
                                       recursive=True)}

            def find_seg(p):
                stem = os.path.basename(p)
                for cand in (stem.replace(".pcd.bin", "_lidarseg.bin"),
                             stem + "_lidarseg.bin"):
                    if cand in segs:
                        return segs[cand]
                return None

            pairs = [(p, find_seg(p), None) for p in lid]
            n_unlabeled = sum(1 for p in pairs if p[1] is None)
            if n_unlabeled:
                print(f"[nuscenes] WARNING: glob fallback could not pair "
                      f"lidarseg labels for {n_unlabeled}/{len(pairs)} "
                      f"frames (token-named lidarseg files need the devkit "
                      f"or an info pkl); those frames carry zero labels")
            # no scene metadata here either: deterministic 9:1 modulo
            # split so train and val at least never overlap
            if self.split in ("train", "val"):
                keep = (lambda i: i % 10 != 0) if self.split == "train" \
                    else (lambda i: i % 10 == 0)
                pairs = [p for i, p in enumerate(pairs) if keep(i)]
            return pairs

    def __len__(self):
        return len(self.pairs)

    def get(self, idx, rng=None, augment=False):
        lidar_path, seg_path, sd_token = self.pairs[idx]
        raw = np.fromfile(lidar_path, np.float32).reshape(-1, 5)
        pts, refl, beams = raw[:, :3], raw[:, 3:4], raw[:, 4].astype(np.int64)
        if seg_path and os.path.exists(seg_path):
            labels = _map_labels(np.fromfile(seg_path, np.uint8),
                                 NUSCENES_LEARNING_MAP)
        else:
            labels = np.zeros(len(pts), np.int32)
        reorder, inv, cid = extract_curves_beams(pts, beams,
                                                 self.curve_thresh)
        pts, refl, labels = pts[reorder], refl[reorder], labels[reorder]
        if augment and rng is not None and self.polarmix_aug:
            j = int(rng.integers(len(self.pairs)))
            lp2, sp2, _ = self.pairs[j]
            raw2 = np.fromfile(lp2, np.float32).reshape(-1, 5)
            y2 = (_map_labels(np.fromfile(sp2, np.uint8),
                              NUSCENES_LEARNING_MAP)
                  if sp2 and os.path.exists(sp2)
                  else np.zeros(len(raw2), np.int32))
            ro2, _, c2 = extract_curves_beams(raw2[:, :3],
                                              raw2[:, 4].astype(np.int64),
                                              self.curve_thresh)
            pk1 = np.concatenate([pts, refl, cid[:, None]], 1)
            pk2 = np.concatenate(
                [raw2[ro2, :3], raw2[ro2, 3:4],
                 (c2 + cid.max() + 1)[:, None]], 1)
            mixed, labels = polarmix(rng, pk1, labels, pk2, y2[ro2],
                                     NUSCENES_INSTANCE_CLASSES)
            pts, refl, cid = (mixed[:, :3], mixed[:, 3:4],
                              mixed[:, 4].astype(np.int32))
        if augment and rng is not None:
            pts = _lidar_augment(pts.astype(np.float32), rng)
        pts = pts / self.pos_normalize
        # submission filename: the official format (and the reference,
        # nuscenes_dataset.py:80-85) names dumps '<sd_token>_lidarseg.bin';
        # the seg file's basename IS that (token-named), and on the test
        # split the token from the index takes its place
        if seg_path:
            fname = os.path.basename(seg_path)
        elif sd_token:
            fname = f"{sd_token}_lidarseg.bin"
        else:
            fname = os.path.basename(lidar_path) + "_lidarseg.bin"
        meta = {"format": "nuscenes", "fname": fname, "reorder": inv}
        return Sample(pos=pts.astype(np.float32), curve_id=cid,
                      feat=refl.astype(np.float32),
                      labels=labels.astype(np.int32), meta=meta)


class SemA2D2(CurveDataset):
    """Audi A2D2 camera-lidar segmentation (reference audi_dataset.py).

    Expects the preprocessed npz layout: one file per frame with points /
    reflectance / lidar_id / timestamp / labels arrays."""

    CURVE_THRESHES = [0.1, 0.17, 0.1, 0.12, 0.1]
    KNN = [4, 4, 4, 3, 4]

    def __init__(self, data_path: str, split: str = "train",
                 n_pad: int = 32768, pos_normalize: float = 30.0):
        pattern = os.path.join(data_path, split, "*.npz")
        self.fpaths = sorted(glob.glob(pattern))
        if not self.fpaths:
            _no_frame("A2D2", split, pattern)
        self.split = split
        self.n_pad = n_pad
        self.in_dim = 4
        self.n_classes = 13
        self.task = "segmentation"
        self.ignore_index = 12
        self.pos_normalize = pos_normalize

    def __len__(self):
        return len(self.fpaths)

    def get(self, idx, rng=None, augment=False):
        with np.load(self.fpaths[idx]) as npz:
            blob = {k: npz[k] for k in ("points", "reflectance", "lidar_id",
                                        "timestamp", "labels")}
        pts_all, labels_all, refl_all, cid_all = [], [], [], []
        total = 0
        for sid in np.unique(blob["lidar_id"].astype(np.int64)):
            m = blob["lidar_id"] == sid
            p, t = blob["points"][m], blob["timestamp"][m]
            reorder, cid = extract_curves_knn(
                p, t, k=self.KNN[sid], thresh=self.CURVE_THRESHES[sid])
            pts_all.append(p[reorder])
            labels_all.append(blob["labels"][m][reorder])
            refl_all.append(blob["reflectance"][m][reorder])
            cid_all.append(cid + total)
            total += cid.max() + 1 if len(cid) else 0
        pts = np.concatenate(pts_all)
        labels = np.concatenate(labels_all)
        refl = np.concatenate(refl_all).reshape(-1, 1)
        cid = np.concatenate(cid_all)
        cid = np.unique(cid, return_inverse=True)[1].astype(np.int32)
        if augment and rng is not None:
            pts = _lidar_augment(pts.astype(np.float32), rng)
        pts = pts / self.pos_normalize
        return Sample(pos=pts.astype(np.float32), curve_id=cid,
                      feat=refl.astype(np.float32),
                      labels=labels.astype(np.int32))


def load_lidar_datasets(cfg, n_pad):
    src = cfg["dataset_source"]
    path = cfg["data_path"]
    pm = bool(cfg.get("polarmix", True))
    if src == "kitti":
        return (SemKITTI(path, "train", n_pad, pm),
                SemKITTI(path, "val", n_pad, False))
    if src == "nuscenes":
        return (SemNuScenes(path, "train", n_pad, pm),
                SemNuScenes(path, "val", n_pad, False))
    if src == "audi":
        return (SemA2D2(path, "train", n_pad),
                SemA2D2(path, "val", n_pad))
    raise KeyError(src)
