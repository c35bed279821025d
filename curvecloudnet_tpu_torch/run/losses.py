"""Segmentation and classification losses (counterpart of
``curvecloudnet_tpu/run/losses.py``).

Lovász-Softmax sorts every class's errors in one sort over the point axis;
invalid (padded or ignored) rows get the error -1 and sort last, and the
Jaccard gradient is data (no gradient through the sort), as in the JAX
package and the reference's autograd.  On bfloat16 logits the NLL runs in
the logits' dtype and the Lovász term in float32 (its foreground indicator,
errors, cumulative counts and sums), as the JAX package promotes them: a
bfloat16 count is exact only up to 256.  The bfloat16 softmax and
log-softmax round each operation as ``jax.nn.softmax`` /
``jax.nn.log_softmax`` do op by op (torch's fused bfloat16 versions round
once, at the end).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import parallel


def _shifted(x):
    return x - x.amax(dim=-1, keepdim=True).detach()


def log_softmax(x):
    """``log_softmax`` over the last axis; in a sub-float32 dtype with each
    operation rounded to it, as ``jax.nn.log_softmax``."""
    if x.dtype == torch.float32:
        return torch.log_softmax(x, dim=-1)
    s = _shifted(x)
    return s - torch.log(torch.exp(s).sum(dim=-1, keepdim=True))


def softmax(x):
    """``softmax`` over the last axis, rounded as ``jax.nn.softmax``."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    e = torch.exp(_shifted(x))
    return e / e.sum(dim=-1, keepdim=True)


def nll_loss(log_probs, labels, valid, ignore_index: Optional[int] = None,
             class_weights=None, mean_over_all: bool = False):
    """Masked NLL.  ``mean_over_all=False``: torch ``nll_loss`` 'mean' with
    ``ignore_index`` (sum of weighted losses / sum of weights);
    ``mean_over_all=True``: the KITTI variant, averaged over every valid
    point."""
    labels = labels.long()
    counted = valid
    if ignore_index is not None:
        counted = counted & (labels != ignore_index)
    safe = torch.clamp(labels, 0, log_probs.shape[-1] - 1)
    picked = torch.gather(log_probs, -1, safe[..., None])[..., 0]
    w = (class_weights[safe] if class_weights is not None
         else torch.ones_like(picked))
    w = torch.where(counted, w, torch.zeros_like(w))
    terms = -torch.where(counted, picked * w, torch.zeros_like(picked))
    if parallel.world() > 1:
        if mean_over_all:
            return _global_ratio(terms, valid, lambda d: torch.clamp(
                d.long(), min=1).to(terms.dtype))
        return _global_ratio(terms, w, lambda d: torch.clamp(
            d.to(w.dtype), min=1e-12))
    num = terms.sum()
    if mean_over_all:
        den = torch.clamp(valid.sum(), min=1).to(num.dtype)
    else:
        den = torch.clamp(w.sum(), min=1e-12)
    return num / den


def _global_ratio(terms, weights, finish):
    """sum(terms) / sum(weights) over every process's rows, in a
    data-parallel step: the value is the global sums' ratio, each sum
    accumulated in float32 and rounded once (``finish`` gives the
    denominator the single-process form: its clamp and dtype), as one
    process rounds its sums; the gradient is this process's terms over the
    global denominator."""
    num_g, den_g = parallel.reduce_sum(torch.stack(
        [terms.detach().float().sum(), weights.detach().float().sum()]
    )).unbind(0)
    den_g = finish(den_g)
    return parallel.with_value(terms.sum() / den_g,
                               num_g.to(terms.dtype) / den_g)


def lovasz_softmax(probs, labels, valid):
    """Multi-class Lovász-Softmax over the present classes.  probs (N, C),
    labels (N,), valid (N,) with ignored rows already masked out; float32
    whatever the dtype of probs.  In a data-parallel step it sorts every
    process's rows (in rank order, the single-process order of the global
    batch); the gradient reaches this process's rows."""
    if parallel.world() > 1:
        probs = parallel.global_rows(probs)
        meta = parallel.all_gather_rows(torch.stack(
            [labels.long(), valid.long()], dim=1))
        labels, valid = meta[:, 0], meta[:, 1] > 0
    n, c = probs.shape
    fg = (labels.long()[:, None] == torch.arange(c, device=probs.device)) \
        & valid[:, None]
    fgf = fg.float()
    errors = torch.abs(fgf - probs)
    errors = torch.where(valid[:, None], errors, torch.full_like(errors, -1.0))
    err_sorted, perm = torch.sort(errors.detach(), dim=0, descending=True,
                                  stable=True)
    fg_sorted = torch.gather(fgf, 0, perm)
    valid_sorted = (err_sorted >= 0).float()
    gts = fgf.sum(dim=0)
    intersection = gts - torch.cumsum(fg_sorted, dim=0)
    union = gts + torch.cumsum((1.0 - fg_sorted) * valid_sorted, dim=0)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    grad = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]], dim=0)
    grad = grad * valid_sorted
    grad_unsorted = torch.zeros_like(grad).scatter_(0, perm, grad)
    losses = (errors * grad_unsorted).sum(dim=0)
    present = gts > 0
    return (torch.where(present, losses, torch.zeros_like(losses)).sum()
            / torch.clamp(present.sum(), min=1))


def seg_loss(logits, labels, valid, ignore_index: Optional[int] = 0,
             use_lovasz: bool = False, lovasz_weight: float = 1.0,
             class_weights=None, mean_over_all: bool = False):
    """NLL (+ weighted Lovász) over the flattened batch: the reference's
    ``seg_loss`` (nuScenes, lovasz_weight 1) and ``seg_loss_kitti``."""
    c = logits.shape[-1]
    flat_logits = logits.reshape(-1, c)
    flat_labels = labels.reshape(-1)
    flat_valid = valid.reshape(-1)
    logp = log_softmax(flat_logits)
    loss = nll_loss(logp, flat_labels, flat_valid, ignore_index,
                    class_weights, mean_over_all)
    if use_lovasz:
        lov_valid = flat_valid
        if ignore_index is not None:
            lov_valid = lov_valid & (flat_labels != ignore_index)
        loss = loss + lovasz_weight * lovasz_softmax(
            softmax(flat_logits), flat_labels, lov_valid)
    return loss


def classification_loss(logits, labels):
    """Cross-entropy of per-sample logits (B, C) at the labels (B,): the
    mean NLL of ``log_softmax`` (the reference's shape classification)."""
    logp = log_softmax(logits)
    picked = torch.gather(logp, -1, labels.long()[:, None])
    if parallel.world() > 1:
        return _global_ratio(-picked, torch.ones_like(picked),
                             lambda d: d.to(picked.dtype))
    return -picked.mean()
