"""Exact k-nearest-neighbor searches and per-row shared tables
(counterpart of ``curvecloudnet_tpu/ops/neighbors.py``, exact paths only).

Outputs are dense ``(B, Q, K)`` neighbor indices with ``-1`` fill.  Every
3D search at one resolution row is a filtered view of ONE exact k=32 table
of that row (the k'-nearest-within-r of a query are a prefix of its
32-nearest when k' <= 32), built radius-bounded at the largest radius any
consumer of the row uses (``models/base.row_radius_bounds``).  All searches
run kernel K3 (``ops/knn.py``); every row of the flagship fits a table
(at most ``TABLE_MAX_N`` points).
"""

from __future__ import annotations

import torch

from . import knn as _k3
from .gather import gather_rows_km
from .knn import INF
from .segments import take_rows

# Largest row served by a shared table (the JAX package's BRUTE_MAX_N;
# above it the JAX package switches to its grid search on the TPU, and
# the port searches per consumer).
TABLE_MAX_N = 24576
TABLE_K = 32


def knn(query, points, q_valid, p_valid, k: int, radius=None):
    """Exact masked kNN: (idx (B, Q, k) int32 with -1 fill, dist (B, Q, k)
    f32 with 1e30 fill); neighbors beyond ``radius`` are dropped."""
    return _k3.knn_search(query, points, q_valid, p_valid,
                          min(k, points.shape[1]), radius)


class TableCache:
    """Per-forward cache of the per-row tables, keyed by the identity of
    the row's (pos, valid) tensors and the table's radius bound."""

    def __init__(self):
        self._tables = {}

    def row_table(self, pos, valid, bound=None):
        """Build or fetch the row's exact k=32 table, or None for rows
        above ``TABLE_MAX_N``."""
        if pos.shape[1] > TABLE_MAX_N:
            return None
        key = (id(pos), id(valid), None if bound is None else float(bound))
        hit = self._tables.get(key)
        if hit is not None and hit[0] is pos and hit[1] is valid:
            return hit[2]
        table = knn(pos, pos, valid, valid, TABLE_K, radius=bound)
        self._tables[key] = (pos, valid, table)
        return table


def _filter_table(idx, dist, k: int, radius):
    """First k entries within ``radius`` (entries ascend by distance, so the
    kept entries stay a prefix)."""
    if radius is not None:
        keep = dist <= radius
        idx = torch.where(keep, idx, torch.full_like(idx, -1))
        dist = torch.where(keep, dist, torch.full_like(dist, INF))
    return idx[..., :k], dist[..., :k]


def same_set_knn(pos, valid, k: int, radius=None, table_bound=None,
                 tables: TableCache | None = None):
    """kNN of a 3D point set against itself via the shared row table."""
    if tables is not None and k <= TABLE_K:
        table = tables.row_table(pos, valid, table_bound)
        if table is not None:
            return _filter_table(*table, k, radius)
    return knn(pos, pos, valid, valid, k, radius=radius)


def subset_knn(pos, valid, sub_idx, sub_valid, k: int, radius=None,
               table_bound=None, tables: TableCache | None = None):
    """kNN of row-subset queries ``pos[sub_idx]`` against the full row."""
    if tables is not None and k <= TABLE_K:
        table = tables.row_table(pos, valid, table_bound)
        if table is not None:
            idx, dist = (take_rows(t, sub_idx) for t in table)
            sv = sub_valid[..., None]
            idx = torch.where(sv, idx, torch.full_like(idx, -1))
            dist = torch.where(sv, dist, torch.full_like(dist, INF))
            return _filter_table(idx, dist, k, radius)
    return knn(take_rows(pos, sub_idx), pos, sub_valid, valid, k, radius=radius)


def add_self_loops(idx, q_valid):
    """Prepend each query's own index as neighbor 0 (query set == row)."""
    b, q, _ = idx.shape
    self_idx = torch.arange(q, dtype=idx.dtype, device=idx.device)
    self_idx = torch.where(q_valid, self_idx[None, :],
                           torch.full_like(self_idx[None, :], -1))
    return torch.cat([self_idx[..., None], idx], dim=-1)


def gather_neighbors(x, idx, fill: bool = True, layout=None):
    """Rows of x (B, N, C) at idx (B, ...) with -1 fill -> (B, ..., C); -1
    slots read zeros (``fill``) or row 0 (every consumer masks them).

    ``layout="kq"``: idx is (B, K, Q) k-major; a self-row gather (Q == N,
    the edge convs) goes through kernels K4/K4b (``ops/gather.py``) in eval
    and train alike.  Subset gathers stay plain indexing, as in the JAX
    package."""
    if layout == "kq" and idx.dim() == 3 and idx.shape[2] == x.shape[1]:
        return gather_rows_km(x, idx, fill)
    b, c = x.shape[0], x.shape[-1]
    out = take_rows(x, torch.clamp(idx, min=0).reshape(b, -1))
    out = out.reshape(idx.shape + (c,))
    if fill:
        out = torch.where((idx >= 0)[..., None], out, torch.zeros_like(out))
    return out
