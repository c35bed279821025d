"""Evaluation metrics: confusion histograms, IoU, classification stats
(counterpart of ``curvecloudnet_tpu/run/metrics.py``).

The histograms run on the tensors' device with a fixed n x n output (a
``scatter_add_`` into zeros), never ``torch.bincount``, which syncs the
host on CUDA to size its output; the eval loop keeps one host sync a
scan.  The scores are host-side numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def fast_hist(pred, label, n: int) -> torch.Tensor:
    """n x n int64 confusion counts (rows = label, cols = pred); entries
    outside [0, n) are parked in a dropped bin."""
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
    k = (label >= 0) & (label < n) & (pred >= 0) & (pred < n)
    idx = torch.where(k, n * label + pred, torch.full_like(label, n * n))
    counts = torch.zeros(n * n + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts[: n * n].reshape(n, n)


def masked_hist(pred, label, valid, n: int) -> torch.Tensor:
    """:func:`fast_hist` over the valid entries only."""
    off = torch.full_like(pred.long(), -1)
    return fast_hist(torch.where(valid, pred.long(), off),
                     torch.where(valid, label.long(), off), n)


def fast_hist_crop(pred, label, valid, num_classes: int) -> torch.Tensor:
    """Histogram over classes 1..num_classes-1 (class 0 = ignore), the
    reference's ``fast_hist_crop`` (nuscenes_seg.py:245-249)."""
    return masked_hist(pred, label, valid, num_classes)[1:, 1:]


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def per_class_iu(hist) -> np.ndarray:
    """Per-class IoU from a confusion histogram; NaN for absent classes."""
    hist = _host(hist).astype(np.float64)
    denom = hist.sum(1) + hist.sum(0) - np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / denom


def miou(hist) -> float:
    return float(np.nanmean(per_class_iu(hist)))


def confmat2acc(confmat) -> tuple[float, float]:
    """(accuracy, balanced accuracy) from a confusion matrix."""
    confmat = _host(confmat).astype(np.float64)
    acc = np.diag(confmat).sum() / max(confmat.sum(), 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(confmat) / confmat.sum(1)
    bal = float(np.nanmean(per_class))
    return float(acc), bal


def confmat2precrec(confmat):
    """Per-class precision / recall / F1."""
    confmat = _host(confmat).astype(np.float64)
    tp = np.diag(confmat)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = tp / confmat.sum(0)
        rec = tp / confmat.sum(1)
        f1 = 2 * prec * rec / (prec + rec)
    return prec, rec, f1


def part_iou_shapenet(pred, label, valid, parts: np.ndarray) -> float:
    """Instance part-IoU of one object over its category's part set
    (reference shapenet_seg.py:91-99): a part absent from both prediction
    and label counts as IoU 1."""
    valid = _host(valid)
    pred = _host(pred)[valid]
    label = _host(label)[valid]
    ious = []
    for p in parts:
        pr = pred == p
        gt = label == p
        union = np.logical_or(pr, gt).sum()
        if union == 0:
            ious.append(1.0)
        else:
            ious.append(np.logical_and(pr, gt).sum() / union)
    return float(np.mean(ious))
