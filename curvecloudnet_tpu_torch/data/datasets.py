"""Dataset classes emitting padded curve-cloud samples (counterpart of
``curvecloudnet_tpu/data/datasets.py``).

Every sample is padded to the dataset's static ``n_pad`` and batches are
fixed-shape numpy arrays, so every forward of a run has one shape.  A
sample is drawn from ``seed * 100003 + idx``, as in the JAX package, so
both packages give the same sample for the same (seed, idx).

Included sources: ``SyntheticLidarSeg`` / ``SyntheticObjects``, procedural
data on :mod:`.synthetic`.  The readers of real files (the JAX package's
``ObjectPthDataset`` and its lidar datasets) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from . import synthetic


@dataclasses.dataclass
class Sample:
    pos: np.ndarray            # (N, 3)
    curve_id: np.ndarray       # (N,)
    feat: Optional[np.ndarray]  # (N, F) or None
    labels: np.ndarray         # (N,) seg labels or scalar class
    category: int = 0          # object category (ShapeNet)
    # host-side metadata, never sent to the device: e.g. the submission
    # file name and the inverse reorder permutation
    meta: Optional[dict] = None


class CurveDataset:
    """Base: fixed padded size, task metadata, indexable samples."""

    n_pad: int
    in_dim: int
    n_classes: int
    task: str = "segmentation"
    ignore_index: Optional[int] = 0

    def __len__(self) -> int:
        raise NotImplementedError

    def get(self, idx: int, rng: Optional[np.random.Generator] = None,
            augment: bool = False) -> Sample:
        raise NotImplementedError


class SyntheticLidarSeg(CurveDataset):
    """Procedural rotating-lidar sweeps (nuScenes-like: 17 classes, ignore
    0); each has a random [0.85, 1] share of ``n_pad`` points."""

    def __init__(self, n_samples: int = 64, n_pad: int = 8192,
                 n_classes: int = 17, n_beams: int = 32, seed: int = 0):
        self.n_samples = n_samples
        self.n_pad = n_pad
        self.in_dim = 4
        self.n_classes = n_classes
        self.n_beams = n_beams
        self.seed = seed
        self.task = "segmentation"
        self.ignore_index = 0

    def __len__(self):
        return self.n_samples

    def get(self, idx, rng=None, augment=False):
        g = np.random.default_rng(self.seed * 100003 + idx)
        n = int(g.integers(int(self.n_pad * 0.85), self.n_pad + 1))
        pos, refl, cid, y = synthetic.lidar_sweep(
            g, n, self.n_beams, self.n_classes)
        if augment and rng is not None:
            pos = _lidar_augment(pos, rng)
        return Sample(pos=pos, curve_id=cid, feat=refl, labels=y)


class SyntheticObjects(CurveDataset):
    """Procedural scanned objects; classification or part segmentation."""

    def __init__(self, n_samples: int = 64, n_pad: int = 2048,
                 task: str = "classification", n_parts: int = 4,
                 seed: int = 0):
        self.n_samples = n_samples
        self.n_pad = n_pad
        self.in_dim = 3
        self.task = task
        self.n_parts = n_parts
        self.n_classes = 3 if task == "classification" else n_parts
        self.ignore_index = None
        self.seed = seed

    def __len__(self):
        return self.n_samples

    def get(self, idx, rng=None, augment=False):
        g = np.random.default_rng(self.seed * 100003 + idx)
        pos, cid, parts, cat = synthetic.object_scan(
            g, self.n_pad, n_parts=self.n_parts)
        if augment and rng is not None:
            pos = _object_augment(pos, rng)
        labels = (np.int32(cat) if self.task == "classification" else parts)
        return Sample(pos=pos, curve_id=cid, feat=None, labels=labels,
                      category=cat)


def _object_augment(pos, rng):
    """ShapeNet train augmentation: random anisotropic scale + jitter
    (reference object_datasets.py:32-36)."""
    scale = rng.uniform(2.0 / 3.0, 3.0 / 2.0, size=(1, 3)).astype(np.float32)
    jitter = np.clip(rng.normal(0, 0.01, pos.shape), -0.05,
                     0.05).astype(np.float32)
    return pos * scale + jitter


def _lidar_augment(pos, rng):
    """Lidar train augmentation: rotate about z, flip, scale, translate
    (reference kitti_dataset.py:123-152)."""
    theta = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pos = pos @ rot.T
    if rng.random() < 0.5:
        pos[:, 0] *= -1
    if rng.random() < 0.5:
        pos[:, 1] *= -1
    pos *= rng.uniform(0.95, 1.05)
    pos[:, :2] += rng.normal(0, 0.1, size=(1, 2)).astype(np.float32)
    return pos


# ---------------------------------------------------------------------------
# Padded batching
# ---------------------------------------------------------------------------

def pad_sample(sample: Sample, n_pad: int) -> Dict[str, np.ndarray]:
    n = min(len(sample.pos), n_pad)
    pos = np.zeros((n_pad, 3), np.float32)
    cid = np.zeros((n_pad,), np.int32)
    valid = np.zeros((n_pad,), bool)
    pos[:n] = sample.pos[:n]
    cid[:n] = sample.curve_id[:n]
    valid[:n] = True
    out = dict(pos=pos, curve_id=cid, valid=valid,
               category=np.int32(sample.category),
               # points dropped by the static row size, reported by the
               # eval loop with the overflow telemetry
               n_pad_dropped=np.int32(max(0, len(sample.pos) - n_pad)))
    if sample.feat is not None:
        f = np.zeros((n_pad, sample.feat.shape[-1]), np.float32)
        f[:n] = sample.feat[:n]
        out["feat"] = f
    if np.ndim(sample.labels) == 0:
        out["labels"] = np.asarray(sample.labels, np.int32)
    else:
        y = np.zeros((n_pad,), np.int32)
        y[:n] = sample.labels[:n]
        out["labels"] = y
    return out


def collate(dataset: CurveDataset, raw) -> Dict[str, np.ndarray]:
    """Padded samples stacked into one batch dict (``_meta``: the samples'
    metadata, where any has some)."""
    samples = [pad_sample(s, dataset.n_pad) for s in raw]
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    metas = [s.meta for s in raw]
    if any(m is not None for m in metas):
        out["_meta"] = metas
    return out


def batch_iterator(dataset: CurveDataset, batch_size: int,
                   shuffle: bool = False, seed: int = 0,
                   augment: bool = False,
                   drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked padded batches as numpy dicts (host-side pipeline)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    n = len(order)
    stop = n - batch_size + 1 if drop_last else n
    for start in range(0, max(stop, 0), batch_size):
        idxs = order[start:start + batch_size]
        yield collate(dataset, [dataset.get(int(i), rng=rng, augment=augment)
                                for i in idxs])


def to_device_batch(np_batch: Dict[str, np.ndarray], task: str, device):
    """numpy batch dict -> ``train.Batch`` on ``device``, in one transfer.

    The (B, N, *) fields are packed into one float32 host buffer (pinned
    for a CUDA device), copied once with ``non_blocking=True`` and split on
    the device, as the JAX function packs them for one transfer a batch.
    Channels: pos (3) | feat (F) | curve_id | valid | labels (per point, or
    the sample's class broadcast) | category (broadcast); int fields ride
    as their float32 bit patterns.  Each call fills a fresh host buffer,
    so no buffer is rewritten while its copy may be in flight (the caching
    host allocator hands a freed pinned block out again only after the
    copies that read it have completed)."""
    from ..models.cloud import cloud_from_arrays
    from ..train.trainer import Batch

    device = torch.device(device)
    pos = np.asarray(np_batch["pos"], np.float32)
    b, n = pos.shape[:2]
    feat = (np.asarray(np_batch["feat"], np.float32)
            if "feat" in np_batch else None)
    n_feat = 0 if feat is None else feat.shape[-1]
    labels = np.asarray(np_batch["labels"], np.int32)
    row_labels = labels.ndim == 2 and labels.shape[1] == n
    c = 3 + n_feat
    host = torch.empty((b, n, c + 4), dtype=torch.float32,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    ints = buf.view(np.int32)
    buf[..., 0:3] = pos
    if feat is not None:
        buf[..., 3:c] = feat
    ints[..., c] = np_batch["curve_id"]
    buf[..., c + 1] = np_batch["valid"]
    ints[..., c + 2] = labels if row_labels else labels.reshape(b, 1)
    ints[..., c + 3] = np.asarray(np_batch["category"],
                                  np.int32).reshape(b, 1)
    dev = host.to(device, non_blocking=True)
    dev_ints = dev.view(torch.int32)
    d_labels = dev_ints[..., c + 2] if row_labels else dev_ints[:, 0, c + 2]
    cloud = cloud_from_arrays(
        dev[..., 0:3].contiguous(), dev_ints[..., c].contiguous(),
        dev[..., c + 1] > 0.5,
        dev[..., 3:c].contiguous() if n_feat else None)
    return Batch(cloud=cloud, labels=d_labels.contiguous(),
                 categories=dev_ints[:, 0, c + 3].contiguous())
