"""k-NN inverse-distance-squared feature interpolation (PointNet++ FP)
(counterpart of ``curvecloudnet_tpu/ops/interpolate.py``, f32 paths)."""

from __future__ import annotations

import torch

from . import curve1d, neighbors, telemetry
from .knn import INF
from .sampling import mask_to_indices
from .segments import sq_norm3, take_rows

# Static dropped-query budget of the split fp sweep: n - int(0.70 * m)
# queries.  Queries past the budget keep zero neighbors (zero features),
# exactly as in the JAX package.
SPLIT_KEEP_FRAC = 0.70


def _weighted_mean(x_nbr, d2, mask):
    """Inverse-d^2 weighted mean over the K axis with validity mask."""
    w = 1.0 / torch.clamp(d2, min=1e-16)
    w = torch.where(mask, w, torch.zeros_like(w))
    num = (x_nbr * w[..., None]).sum(dim=-2)
    den = w.sum(dim=-1, keepdim=True)
    return num / torch.clamp(den, min=1e-16)


def knn_interpolate(x, pos_src, src_valid, pos_dst, dst_valid, k: int = 3):
    """Features of the src points (B, M, C) at the dst points (B, N, C):
    the k nearest valid src points of each dst point (kernel K3),
    inverse-d^2 weighted (the fp upsample of a cloud with no
    ``parent_idx``)."""
    idx, dist = neighbors.knn(pos_dst, pos_src, dst_valid, src_valid, k)
    return _weighted_mean(neighbors.gather_neighbors(x, idx), dist * dist,
                          idx >= 0)


def _cand_rank(cand_idx, cand_valid, n: int):
    """Row -> candidate-slot rank (-1 where not kept)."""
    b, m = cand_idx.shape
    dump = torch.where(cand_valid, cand_idx.long(), torch.full_like(cand_idx.long(), n))
    rank = torch.full((b, n + 1), -1, dtype=torch.int64, device=cand_idx.device)
    rank.scatter_(1, dump, torch.arange(m, device=cand_idx.device).expand(b, m))
    return rank[:, :n]


def knn_interpolate_subset(x_cand, cand_idx, cand_valid, pos_full, full_valid,
                           k: int = 3, cand_pos=None):
    """fp upsample when the sources are a subset of the query row.

    A kept query's nearest candidate is itself (d = 0, weight 1e16), so the
    distance sweep (kernel K3) runs only over the dropped queries,
    compacted into a static budget of ``n - int(SPLIT_KEEP_FRAC * m)``.
    """
    k = min(k, cand_idx.shape[1])
    if cand_pos is None:
        cand_pos = take_rows(pos_full, cand_idx)
    b, n = full_valid.shape
    m = cand_idx.shape[1]
    rank = _cand_rank(cand_idx, cand_valid, n)
    kept = (rank >= 0) & full_valid
    dropped = full_valid & ~kept
    budget = min(n, max(k, n - int(SPLIT_KEEP_FRAC * m)))
    d_idx, d_valid = mask_to_indices(dropped, budget, telemetry_name=None)
    if telemetry.active():
        n_drop = dropped.sum(dim=-1)
        telemetry.record(f"fp_split_overflow.n{n}",
                         torch.clamp(n_drop - budget, min=0).sum())
    di, dd = neighbors.knn(take_rows(pos_full, d_idx), cand_pos, d_valid,
                           cand_valid, k)

    base_i = torch.full((b, n + 1, k), -1, dtype=torch.int64, device=rank.device)
    base_i[:, :n, 0] = torch.where(kept, rank, torch.full_like(rank, -1))
    base_d = torch.where(base_i >= 0, torch.zeros((), device=rank.device),
                         torch.full((), INF, device=rank.device))
    tgt = torch.where(d_valid, d_idx, torch.full_like(d_idx, n))
    tgt = tgt[..., None].expand(b, budget, k)
    idx = base_i.scatter(1, tgt, di.long())[:, :n]
    dist = base_d.scatter(1, tgt, dd)[:, :n]
    x_nbr = neighbors.gather_neighbors(x_cand, idx)
    return _weighted_mean(x_nbr, dist * dist, idx >= 0)


def knn_interpolate_1d(x_kept, kept_idx, kept_valid, pos_full, curve_id,
                       valid, k: int):
    """Interpolate kept-point features back to full resolution along
    curves: the k geodesically-nearest kept points, inverse-d^2 weighted."""
    nbr, mask = curve1d.knn_1d_group_superset(
        pos_full, kept_idx, kept_valid, curve_id, valid, k)
    rec = torch.cat([x_kept, take_rows(pos_full, kept_idx)], dim=-1)
    rec_nbr = neighbors.gather_neighbors(rec, nbr, fill=False)
    x_nbr, p_nbr = rec_nbr[..., :-3], rec_nbr[..., -3:]
    d2 = sq_norm3(p_nbr - pos_full[:, :, None, :])
    return _weighted_mean(x_nbr, d2, mask)
