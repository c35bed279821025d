"""Grid-hash fixed-radius kNN (counterpart of
``curvecloudnet_tpu/ops/grid_knn.py``, its hash scheme).

Serves the radius searches on rows above ``neighbors.TABLE_MAX_N`` points:

1. cell coordinates at cell = radius (27-cell stencil) or 2 * radius
   (8-cell stencil), 7 bits per axis clipped to +-64 cells (points beyond
   clamp to the boundary cells and fail the radius test);
2. a multiplicative hash of the packed cell id picks one of 2^hash_bits
   bucket rows; each valid point's record [x, y, z, index] goes to its
   bucket row at its rank within the bucket, ranks from one sort by
   (bucket, shuffled index), so a dense cell keeps a spatially unbiased
   ``cap`` of its points.  Points past the cap spill, in point order, into
   ``overflow_planes`` shared rows that every query reads; points past
   those are dropped and counted (``n_dropped``);
3. per query, the table rows of its stencil cells, a row repeated by a
   hash collision or a clipped coordinate repointed to an always-empty
   fill row, then the overflow rows;
4. a tail: ``"records"`` runs kernel K5, which reads those rows itself;
   ``"planes"`` builds the (Q, S * cap) distance and index planes in torch
   and selects with kernel K10 (``ops/grid_topk.py``).

The table has R = 2^hash_bits + 2 + overflow_planes rows of ``cap``
records a batch row: the bucket rows, the parked row (invalid points in the
JAX package; never read), the overflow rows, the fill row.  The batch's
tables are stacked, so one launch serves every batch row.  Indices are
stored as int32 bits in the records' fourth channel (-1: empty), not in
the JAX package's biased-float encoding, which guards a TPU flush.

Contract: the JAX package's candidate set per query (same cells, same cap
truncation, same overflow spill); exact f32 squared distances within the
radius, ascending, ties to the earlier candidate in (stencil column, slot)
order; -1 / 1e30 fills, padded to k.  The JAX package's own grid
distances are quantized (low mantissa bits cleared by its packed
extraction), so its sets may differ inside that band at the k-th distance
or a filter radius.
"""

from __future__ import annotations

import numpy as np
import torch

from . import grid_topk, telemetry
from .segments import sqrt32

INF = 1e30
_BITS = 7                         # cell-coordinate bits per axis
_OFF = 1 << (_BITS - 1)           # center cells around the origin
_MASK = (1 << _BITS) - 1
TAILS = ("records", "planes")

_OFFSETS = {
    27: torch.tensor([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                      for dz in (-1, 0, 1)], dtype=torch.int64),
    8: torch.tensor([[dx, dy, dz] for dx in (0, 1) for dy in (0, 1)
                     for dz in (0, 1)], dtype=torch.int64),
}


def default_hash_bits(n: int) -> int:
    """Bucket table of about n / 8 rows, 2^13 to 2^18."""
    bits = 1
    while (1 << bits) < n:
        bits += 1
    return min(18, max(13, bits - 3))


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as an f32 scalar tensor on ``like``'s device: arithmetic
    with it rounds as f32 arithmetic with an f32 constant (a Python scalar
    divisor becomes a reciprocal multiply on the card)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def cell_coords(pos, cell: float):
    """(..., 3) f32 -> (..., 3) int64 cell coordinates in [0, 127]."""
    c = torch.floor(pos / _f32(cell, pos))
    return torch.clamp(c, -_OFF, _MASK - _OFF).long() + _OFF


def pack(c):
    return (c[..., 0] << (2 * _BITS)) | (c[..., 1] << _BITS) | c[..., 2]


def hash_cells(cell_id, hash_bits: int):
    """uint32 multiplicative hash (computed in int64), top bits."""
    return ((cell_id * 2654435761) & 0xFFFFFFFF) >> (32 - hash_bits)


def bucket(coords, hash_bits: int):
    """Cell coords (..., 3) -> bucket row index (..., ) int64."""
    return hash_cells(pack(coords), hash_bits)


def table_rows(hash_bits: int, overflow_planes: int) -> int:
    return (1 << hash_bits) + 2 + overflow_planes


def build_table(points, p_valid, cell: float, cap: int, hash_bits: int,
                overflow_planes: int):
    """The stacked record table of a batch of rows.

    Returns (table (B*R, cap, 4) f32, counts (B*R,) int32 live prefix of
    each row, row (B, N) and slot (B, N) int64 of each point's record (row
    -1: not placed), n_dropped (B,) int64)."""
    b, n, _ = points.shape
    dev = points.device
    nb = 1 << hash_bits
    rows = table_rows(hash_bits, overflow_planes)
    bkt = torch.where(p_valid, bucket(cell_coords(points, cell), hash_bits),
                      torch.full((), nb, device=dev))
    iota = torch.arange(n, device=dev)
    shuffled = (iota * 0x9E3779B1) & 0x7FFFFFFF   # distinct for n < 2^31
    base = torch.arange(b, device=dev)[:, None] * rows
    key = (((bkt + base) << 31) | shuffled).reshape(-1)
    order = torch.argsort(key)                     # keys are distinct
    sorted_key = key[order] >> 31
    start = torch.searchsorted(sorted_key, sorted_key)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(b * n, device=dev) - start).reshape(b, n)
    keep = (rank < cap) & p_valid
    row = torch.where(keep, bkt, -1)
    slot = rank
    dropped = p_valid & ~keep
    if overflow_planes > 0:
        grank = torch.cumsum(dropped.long(), dim=1) - 1
        okeep = dropped & (grank < overflow_planes * cap)
        row = torch.where(okeep, nb + 1 + grank // cap, row)
        slot = torch.where(okeep, grank % cap, slot)
        dropped = dropped & ~okeep
    placed = row >= 0
    slot = torch.where(placed, slot, 0)
    flat_row = (row + base)[placed]
    # records as int32 bits: coordinates are copied, never computed on
    rec = torch.cat([points.contiguous().view(torch.int32),
                     iota.int()[None, :, None].expand(b, n, 1)], dim=-1)
    fill = torch.tensor([np.float32(INF).view(np.int32)] * 3 + [-1],
                        dtype=torch.int32, device=dev)
    table = fill.repeat(b * rows, cap, 1)
    table[flat_row, slot[placed]] = rec[placed]
    counts = torch.bincount(flat_row, minlength=b * rows).int()
    row = torch.where(placed, row, -1)
    return table.view(torch.float32), counts, row, slot, dropped.sum(1)


def stencil_rows(query, radius: float, cell: float, stencil: int,
                 hash_bits: int, overflow_planes: int):
    """(B, Q, S) int64 table rows (within one batch row's table) each query
    reads: its stencil cells' rows, duplicates repointed to the fill row,
    then the overflow rows."""
    if stencil == 27:
        qc = cell_coords(query, cell)
    else:
        # the ball [q - r, q + r] spans at most two cells of edge 2r per
        # axis, anchored at floor((q - r) / cell)
        qc = cell_coords(query - _f32(radius, query), cell)
    offs = _OFFSETS[stencil].to(query.device)
    nbr = bucket(torch.clamp(qc[..., None, :] + offs, 0, _MASK), hash_bits)
    s = nbr.shape[-1]
    earlier = torch.ones(s, s, dtype=torch.bool,
                         device=query.device).tril(-1)
    dup = ((nbr[..., :, None] == nbr[..., None, :]) & earlier).any(-1)
    nb = 1 << hash_bits
    nbr = torch.where(dup, nb + 1 + overflow_planes, nbr)
    if overflow_planes > 0:
        ovf = nb + 1 + torch.arange(overflow_planes, device=query.device)
        nbr = torch.cat([nbr, ovf.expand(nbr.shape[:-1] + (overflow_planes,))],
                        dim=-1)
    return nbr


def finalize(top_d2, top_idx, k: int, k_eff: int):
    """Shared tail: restore the -1 / 1e30 fills, drop repeated indices,
    sqrt, pad to k -> (idx, dist)."""
    top_idx = torch.where(top_d2 < INF * 0.98, top_idx,
                          torch.full_like(top_idx, -1))
    top_d2 = torch.where(top_idx >= 0, top_d2, torch.full_like(top_d2, INF))
    same = top_idx[..., :, None] == top_idx[..., None, :]
    earlier = torch.ones(k_eff, k_eff, dtype=torch.bool,
                         device=top_d2.device).tril(-1)
    dup = (same & earlier & (top_d2[..., None, :] < INF)).any(-1)
    ok = (top_d2 < INF) & ~dup
    idx = torch.where(ok, top_idx, torch.full_like(top_idx, -1))
    dist = torch.where(ok, sqrt32(torch.clamp(top_d2, min=0.0)),
                       torch.full_like(top_d2, INF))
    if k_eff < k:
        pad = (0, k - k_eff)
        idx = torch.nn.functional.pad(idx, pad, value=-1)
        dist = torch.nn.functional.pad(dist, pad, value=INF)
    return idx, dist


def grid_knn(query, points, q_valid, p_valid, k: int, radius: float,
             cap: int = 16, stencil: int = 27, hash_bits: int | None = None,
             overflow_planes: int = 0, tail: str = "records"):
    """Batched grid-hash fixed-radius kNN: query (B, Q, 3), points (B, N, 3)
    -> (idx (B, Q, k) int32, dist (B, Q, k) f32, n_dropped (B,) int64)."""
    if tail not in TAILS:
        raise ValueError(f"tail {tail!r} not in {TAILS}")
    b, q, _ = query.shape
    n = points.shape[1]
    if hash_bits is None:
        hash_bits = default_hash_bits(n)
    cell = radius if stencil == 27 else 2.0 * radius
    table, counts, _, _, n_dropped = build_table(
        points, p_valid, cell, cap, hash_bits, overflow_planes)
    rows = table_rows(hash_bits, overflow_planes)
    nbr = stencil_rows(query, radius, cell, stencil, hash_bits,
                       overflow_planes)
    nbr = nbr + torch.arange(b, device=query.device)[:, None, None] * rows
    s = nbr.shape[-1]
    nbr = nbr.reshape(b * q, s).int()
    qf = query.reshape(b * q, 3).contiguous()
    qv = q_valid.reshape(b * q).contiguous()
    k_eff = min(k, s * cap)
    r2 = float(np.float32(radius * radius))
    if tail == "records":
        d2, idx = grid_topk.grid_topk_records(table, counts, nbr, qf, qv,
                                              k_eff, r2)
    else:
        d2, idx = grid_topk.topk_smallest(
            *grid_topk.planes(table, nbr, qf, qv, r2), k_eff)
    idx, dist = finalize(d2, idx, k, k_eff)
    if telemetry.active():
        telemetry.record(f"grid_cap_drop.n{n}.r{radius:g}.s{stencil}",
                         n_dropped.sum())
    return idx.reshape(b, q, k), dist.reshape(b, q, k), n_dropped
