"""Curve-geodesic (along-polyline) operators on batch-padded curve clouds
(counterpart of ``curvecloudnet_tpu/ops/curve1d.py``, eval paths only).

Window offsets inside a candidate window run [0, -1, +1, -2, +2, ...]
(near to far), so "first k valid" truncation selects the same neighbors as
the JAX package and the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import segments, telemetry
from .segments import sq_norm3, take_rows

_FAR = np.float32(100.0)  # invalid-distance fill


def interleaved_offsets(window: int) -> np.ndarray:
    """[0, -1, 1, -2, 2, ..., -window, window] as int64, length 2*window+1."""
    pairs = np.stack([-np.arange(1, window + 1), np.arange(1, window + 1)],
                     axis=1).reshape(-1)
    return np.concatenate([np.zeros(1, np.int64), pairs.astype(np.int64)])


@functools.lru_cache(maxsize=None)
def _index_table(window: int, ascending: bool, device) -> torch.Tensor:
    """The interleaved offsets of a window (or the permutation that sorts
    them ascending) on ``device``, copied there once: a copy from host
    memory makes the host wait for the card.  Made outside inference
    mode, so train-mode indexing can save it."""
    table = interleaved_offsets(window)
    if ascending:
        table = np.argsort(table + window)
    with torch.inference_mode(False):
        return torch.as_tensor(table, device=device)


def _offsets(window: int, device) -> torch.Tensor:
    return _index_table(window, False, torch.device(device))


def shift_fill(x: torch.Tensor, d: int, fill=0) -> torch.Tensor:
    """Shift along axis 1 by d (positive pulls from the right), fill the
    vacated slots."""
    if d == 0:
        return x
    out = torch.full_like(x, fill)
    if d > 0:
        out[:, :-d] = x[:, d:]
    else:
        out[:, -d:] = x[:, :d]
    return out


def same_curve_shift_mask(curve_id, valid, d: int) -> torch.Tensor:
    """(B, N) bool: point i and point i+d exist and share a curve."""
    cid = segments.padded_curve_id(curve_id, valid)
    return (valid & shift_fill(valid, d, False)
            & (cid == shift_fill(cid, d, -1)))


def feature_diffs(x, curve_id, valid) -> torch.Tensor:
    """Per-point |mean of adjacent along-curve feature derivatives|."""
    fwd_ok = same_curve_shift_mask(curve_id, valid, 1).to(x.dtype)
    bwd_ok = same_curve_shift_mask(curve_id, valid, -1).to(x.dtype)
    fwd = (shift_fill(x, 1) - x) * fwd_ok[..., None]
    bwd = (x - shift_fill(x, -1)) * bwd_ok[..., None]
    denom = torch.clamp(fwd_ok + bwd_ok, min=1.0)
    return torch.abs((fwd + bwd) / denom[..., None])


def symmetric_window_concat(x, curve_id, valid, half_k: int) -> torch.Tensor:
    """[x_0, x_{-1}+x_{+1}, ..., x_{-h}+x_{+h}] along the feature axis, a
    tap counting only where both points exist and share the curve: one
    dense layer on it is conv1d-fast-v1's symmetric curve conv over the
    reference's zero-stuffed sequence (one curve at a time)."""
    parts = [x * valid[..., None].to(x.dtype)]
    for d in range(1, half_k + 1):
        m_plus = same_curve_shift_mask(curve_id, valid, d)[..., None]
        m_minus = same_curve_shift_mask(curve_id, valid, -d)[..., None]
        parts.append(shift_fill(x, d) * m_plus.to(x.dtype)
                     + shift_fill(x, -d) * m_minus.to(x.dtype))
    return torch.cat(parts, dim=-1)


def window_concat_nomask(x: torch.Tensor, half_k: int) -> torch.Tensor:
    """[x_0, x_{-1}+x_{+1}, ..., x_{-h}+x_{+h}] along the feature axis with
    plain zero-fill shifts (the gap layout already isolates curves)."""
    parts = [x] + [shift_fill(x, d) + shift_fill(x, -d)
                   for d in range(1, half_k + 1)]
    return torch.cat(parts, dim=-1)


def gap_expand_indices(curve_id, valid, pad: int, curve_budget: int):
    """Index map into the reference's zero-stuffed conv sequence: each row
    becomes ``[gap, curve_0, gap, curve_1, ..., gap]`` of static size
    ``N + pad * (curve_budget + 2)``.

    Returns (exp_idx (B, N) int64 with padding parked at ``n_exp``, n_exp,
    used (B,) int32 = live slots, i.e. the count of the JAX package's
    ``mask_exp``).  Rows with more than ``curve_budget`` curves lose the
    gaps between the excess curves, as in the JAX package.
    """
    b, n = curve_id.shape
    n_exp = n + pad * (curve_budget + 2)
    starts = segments.curve_starts(curve_id, valid) & valid
    rank = torch.clamp(torch.cumsum(starts.long(), dim=-1) - 1, 0, curve_budget)
    iota = torch.arange(n, device=curve_id.device)
    exp_idx = torch.where(valid, iota[None, :] + pad * (rank + 1),
                          torch.full_like(rank, n_exp))
    n_curves = starts.sum(dim=-1)
    used = (valid.sum(dim=-1)
            + pad * (torch.clamp(n_curves, max=curve_budget + 1) + 1))
    return exp_idx, n_exp, used.to(torch.int32)


def gap_scatter(x: torch.Tensor, exp_idx: torch.Tensor, n_exp: int):
    """Scatter (B, N, C) rows into the (B, N_exp, C) gap layout (zeros
    elsewhere); padding rows drop."""
    b, n, c = x.shape
    out = torch.zeros((b, n_exp + 1, c), dtype=x.dtype, device=x.device)
    out.scatter_(1, exp_idx[..., None].expand(b, n, c), x)
    return out[:, :n_exp].contiguous()


def gap_gather(x_exp: torch.Tensor, exp_idx: torch.Tensor, valid):
    """Gather valid rows back out of the gap layout; padding rows read 0."""
    safe = torch.where(valid, exp_idx, torch.zeros_like(exp_idx))
    out = take_rows(x_exp, safe)
    return out * valid[..., None].to(out.dtype)


def _window_candidates(idx, curve_id, valid, idx_valid, window: int):
    """Interleaved-order candidates of each query and their same-curve mask."""
    n = curve_id.shape[1]
    cand = idx.long()[:, :, None] + _offsets(window, idx.device)
    in_range = (cand >= 0) & (cand < n)
    s_q = take_rows(segments.curve_start_index(curve_id, valid), idx)
    e_q = take_rows(segments.curve_end_index(curve_id, valid), idx)
    mask = (in_range & (cand >= s_q[:, :, None]) & (cand <= e_q[:, :, None])
            & idx_valid[:, :, None])
    return torch.clamp(cand, 0, n - 1), mask


def radius_1d_group_subset(pos, idx, idx_valid, curve_id, valid,
                           radius: float, window: int):
    """Geodesic radius grouping along the curve: the radius becomes a
    per-curve neighbor count from the curve's mean edge length, applied
    to a static candidate window.  Returns (nbr_idx, nbr_mask), each
    (B, M, 2*window+1) in interleaved order."""
    elens = segments.edge_lengths(pos, curve_id, valid)
    total_len = segments.per_curve_total(elens, curve_id, valid)
    npts = segments.points_per_curve(curve_id, valid)
    avg_edge = total_len / torch.clamp(npts, min=1.0)
    per_pt_k = torch.ceil(torch.full_like(avg_edge, radius)
                          / torch.clamp(avg_edge, min=1e-12))
    per_pt_k = torch.where(avg_edge <= 1e-12, torch.ones_like(per_pt_k),
                           per_pt_k)
    cand_safe, mask = _window_candidates(idx, curve_id, valid, idx_valid,
                                         window)
    k_q = take_rows(per_pt_k, idx)
    kept = mask & (torch.cumsum(mask.float(), dim=-1) <= k_q[:, :, None])
    if telemetry.active():
        # a query is truncated when its radius wants more neighbors than
        # the static window offers and its curve extends past the window
        wanted = torch.minimum(k_q, take_rows(npts, idx))
        truncated = (mask.sum(dim=-1).float() < wanted) & idx_valid
        nq = torch.clamp(idx_valid.sum(), min=1)
        wanted = torch.where(idx_valid, wanted, torch.zeros_like(wanted))
        telemetry.record("curve_window_truncated_frac", truncated.sum() / nq)
        telemetry.record("curve_window_wanted_max", wanted.max())
        telemetry.record("curve_window_wanted_mean", wanted.sum() / nq)
    return torch.where(kept, cand_safe, torch.full_like(cand_safe, -1)), kept


def window_rows(x: torch.Tensor, idx: torch.Tensor, half_w: int):
    """Per-query windows x[idx-half_w .. idx+half_w] in ASCENDING offset
    order and window-position-major layout: (B, N, C), (B, M) ->
    (B, 2*half_w+1, M, C); rows outside [0, N) read zeros."""
    b, n, c = x.shape
    offs = torch.arange(-half_w, half_w + 1, device=x.device)
    rows = idx.long()[:, None, :] + offs[None, :, None]       # (B, W, M)
    inside = (rows >= 0) & (rows < n)
    got = take_rows(x, torch.clamp(rows, 0, n - 1).reshape(b, -1))
    got = got.reshape(rows.shape + (c,))
    return got * inside[..., None].to(x.dtype)


def ascending_from_interleaved(t: torch.Tensor, half_w: int) -> torch.Tensor:
    """Permute a (..., 2w+1) interleaved-order window tensor to ascending
    offset order [-w..+w]."""
    return t[..., _index_table(half_w, True, t.device)]


def knn_1d_group_superset(pos, kept_idx, kept_valid, curve_id, valid, k: int):
    """For every full-res point, its k geodesically-nearest kept points.

    Each point maps to its sequentially-next kept slot (cumsum
    assignment); the 2k+3 kept slots around it are same-curve filtered and
    the k nearest by Euclidean distance selected.  Selection uses the JAX
    package's packed order exactly: the low 4 mantissa bits of d2 are
    dropped and ties go to the earlier interleaved window column.

    Returns (nbr (B, N, k) slots into the kept array with -1 fill, mask).
    """
    b, n = curve_id.shape
    m = kept_idx.shape[1]
    sel = torch.zeros((b, n), dtype=torch.int64, device=pos.device)
    sel.scatter_add_(1, kept_idx.long(), kept_valid.long())
    assign = torch.cumsum(sel, dim=-1)
    cand = assign[:, :, None] + _offsets(k + 1, pos.device)   # (B, N, W)
    wn = cand.shape[-1]
    in_range = (cand >= 0) & (cand < m)
    cand_safe = torch.clamp(cand, 0, m - 1)
    cid = segments.padded_curve_id(curve_id, valid)
    flat = cand_safe.reshape(b, -1)
    cand_pos = take_rows(take_rows(pos, kept_idx), flat).reshape(b, n, wn, 3)
    cid_c = take_rows(take_rows(cid, kept_idx), flat).reshape(b, n, wn)
    kv_c = take_rows(kept_valid, flat).reshape(b, n, wn)
    mask = in_range & kv_c & (cid[:, :, None] == cid_c) & valid[:, :, None]

    d2 = sq_norm3(cand_pos - pos[:, :, None, :])
    d2 = torch.where(mask, d2, torch.full_like(d2, float(_FAR * _FAR)))
    pw = 1
    while pw < wn:
        pw *= 2
    col = torch.arange(wn, device=pos.device, dtype=torch.int32)
    packed = (d2.view(torch.int32) & ~(pw - 1)) | col
    sent = 0x7F800000 | (pw - 1)
    far_bits = int(np.array(_FAR * _FAR * np.float32(0.99),
                            np.float32).view(np.int32))
    nbrs, oks = [], []
    for _ in range(k):
        mn = packed.min(dim=-1).values                         # (B, N)
        hit = col == (mn & (pw - 1))[..., None]
        nbr_j = torch.where(hit, cand_safe, torch.zeros_like(cand_safe)).sum(-1)
        ok = mn < far_bits
        nbrs.append(torch.where(ok, nbr_j, torch.full_like(nbr_j, -1)))
        oks.append(ok)
        packed = torch.where(hit, torch.full_like(packed, sent), packed)
    return torch.stack(nbrs, dim=-1), torch.stack(oks, dim=-1)
