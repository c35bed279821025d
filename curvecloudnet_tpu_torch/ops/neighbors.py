"""k-nearest-neighbor searches and per-row shared tables (counterpart of
``curvecloudnet_tpu/ops/neighbors.py``).

Outputs are dense ``(B, Q, K)`` neighbor indices with ``-1`` fill.  Every
3D search at one resolution row is a filtered view of ONE k=32 table of
that row (the k'-nearest-within-r of a query are a prefix of its
32-nearest when k' <= 32):

* rows of at most ``TABLE_MAX_N`` points: one exact table (kernel K3,
  ``ops/knn.py``), built radius-bounded at the largest radius any consumer
  of the row uses (``models/base.row_radius_bounds``);
* larger rows: one grid-hash table per (row, radius, cap)
  (``ops/grid_knn.py``, kernel K5), at the search's own radius or, on a
  voxel-produced row, at the row's grid bound with the cap its voxel
  spacing proves.  A radius of 0.15 or more on a row of at most 40960
  points stays exact (such cells hold more points than any affordable
  cap), and a search with no radius is exact too.

Unlike the JAX package on the TPU, rows at or below ``TABLE_MAX_N`` are
never served by the grid (its 8-cell-stencil and "proven grid first"
routes): those answer the TPU's extraction cost, which K3 does not have.
``TABLE_MAX_N`` is read at call time, so tests may lower it.
"""

from __future__ import annotations

import torch

from . import grid_knn as _grid
from . import knn as _k3
from .gather import gather_rows_km
from .knn import INF
from .segments import take_rows

# Largest row served by an exact shared table (the JAX package's
# BRUTE_MAX_N, its TABLE_MAX_N too); larger rows take grid tables.
TABLE_MAX_N = 24576
TABLE_K = 32
# rows up to this size keep searches of radius >= GRID_EXACT_MIN_R exact
GRID_EXACT_MAX_N = 40960
GRID_EXACT_MIN_R = 0.15
GRID_OVERFLOW_PLANES = 2


def grid_cap(k: int) -> int:
    """Per-cell candidate cap of a grid table without a proven cap (sized
    for post-downsampling rows: measured max ~200 points a cell on the
    curve-fps rows in the JAX package)."""
    return max(192, 4 * k)


def search_kernel(n: int, radius, cap=None) -> str:
    """The kernel that serves a 3D search over ``n`` points: "grid_topk"
    (the grid search, K5) or "knn" (exact, K3).  A spec-proven ``cap``
    forces the grid."""
    if radius is None:
        return "knn"
    if cap is not None:
        return "grid_topk"
    if n > TABLE_MAX_N and not (n <= GRID_EXACT_MAX_N
                                and radius >= GRID_EXACT_MIN_R):
        return "grid_topk"
    return "knn"


def knn(query, points, q_valid, p_valid, k: int, radius=None, cap=None):
    """Masked kNN: (idx (B, Q, k) int32 with -1 fill, dist (B, Q, k) f32
    with 1e30 fill); neighbors beyond ``radius`` are dropped.  Exact (K3)
    unless :func:`search_kernel` picks the grid; a proven ``cap`` takes a
    grid table of that cap with 2 more hash bits (fewer collisions merging
    near-full cells), up to 2^16 rows."""
    n = points.shape[1]
    k = min(k, n)
    if search_kernel(n, radius, cap) == "grid_topk":
        hash_bits = None
        if cap:
            hash_bits = _grid.default_hash_bits(n)
            hash_bits = hash_bits + 2 if hash_bits + 2 <= 16 else hash_bits
        idx, dist, _ = _grid.grid_knn(
            query, points, q_valid, p_valid, k, float(radius),
            cap=cap or grid_cap(k), hash_bits=hash_bits,
            overflow_planes=GRID_OVERFLOW_PLANES)
        return idx, dist
    return _k3.knn_search(query, points, q_valid, p_valid, k, radius)


class TableCache:
    """Per-forward cache of the per-row tables, keyed by the identity of
    the row's (pos, valid) tensors and the table's radius (and cap)."""

    def __init__(self):
        self._tables = {}

    def _get(self, key, pos, valid, build):
        hit = self._tables.get(key)
        if hit is not None and hit[0] is pos and hit[1] is valid:
            return hit[2]
        table = build()
        self._tables[key] = (pos, valid, table)
        return table

    def row_table(self, pos, valid, bound=None):
        """Build or fetch the row's exact k=32 table, or None for rows
        above ``TABLE_MAX_N``."""
        if pos.shape[1] > TABLE_MAX_N:
            return None
        key = (id(pos), id(valid), None if bound is None else float(bound))
        return self._get(key, pos, valid, lambda: knn(
            pos, pos, valid, valid, TABLE_K, radius=bound))

    def grid_table(self, pos, valid, radius: float, cap=None):
        """Build or fetch the row's k=32 table at ``radius`` for a row
        above ``TABLE_MAX_N`` (a grid search, or exact where
        :func:`search_kernel` keeps it so)."""
        key = ("grid", id(pos), id(valid), float(radius), cap)
        return self._get(key, pos, valid, lambda: knn(
            pos, pos, valid, valid, TABLE_K, radius=float(radius), cap=cap))


def _filter_table(idx, dist, k: int, radius):
    """First k entries within ``radius`` (entries ascend by distance, so the
    kept entries stay a prefix)."""
    if radius is not None:
        keep = dist <= radius
        idx = torch.where(keep, idx, torch.full_like(idx, -1))
        dist = torch.where(keep, dist, torch.full_like(dist, INF))
    return idx[..., :k], dist[..., :k]


def grid_table_args(radius: float, grid_bound, grid_cap):
    """(radius, cap) of the grid table that serves a search of ``radius``:
    the row's ``grid_bound`` with its proven ``grid_cap`` (declared only
    where voxel spacing proves the cap) when the bound covers the search,
    else the search's own radius with no proven cap."""
    if grid_bound is not None and float(grid_bound) >= float(radius):
        return float(grid_bound), grid_cap
    return radius, None


def _grid_table(tables, pos, valid, radius, grid_bound, grid_cap):
    """(table, its radius) of a search on a row above ``TABLE_MAX_N``."""
    gr, cap = grid_table_args(radius, grid_bound, grid_cap)
    return tables.grid_table(pos, valid, gr, cap), gr


def same_set_knn(pos, valid, k: int, radius=None, table_bound=None,
                 grid_bound=None, grid_cap=None,
                 tables: TableCache | None = None):
    """kNN of a 3D point set against itself via the shared row table."""
    if tables is not None and k <= TABLE_K:
        table = tables.row_table(pos, valid, table_bound)
        if table is not None:
            return _filter_table(*table, k, radius)
        if radius is not None:
            table, gr = _grid_table(tables, pos, valid, radius, grid_bound,
                                    grid_cap)
            return _filter_table(*table, k, radius if gr != radius else None)
    return knn(pos, pos, valid, valid, k, radius=radius)


def subset_knn(pos, valid, sub_idx, sub_valid, k: int, radius=None,
               table_bound=None, grid_bound=None, grid_cap=None,
               tables: TableCache | None = None):
    """kNN of row-subset queries ``pos[sub_idx]`` against the full row."""
    if tables is not None and k <= TABLE_K:
        table = tables.row_table(pos, valid, table_bound)
        if table is None and radius is not None:
            table, gr = _grid_table(tables, pos, valid, radius, grid_bound,
                                    grid_cap)
            if gr == radius:
                radius = None      # the table is filtered at this radius
        if table is not None:
            idx, dist = (take_rows(t, sub_idx) for t in table)
            sv = sub_valid[..., None]
            idx = torch.where(sv, idx, torch.full_like(idx, -1))
            dist = torch.where(sv, dist, torch.full_like(dist, INF))
            return _filter_table(idx, dist, k, radius)
    return knn(take_rows(pos, sub_idx), pos, sub_valid, valid, k, radius=radius)


def ball_query(query, points, q_valid, p_valid, radius: float, k: int = 128):
    """The k nearest valid points within ``radius`` of each query (the JAX
    package's ``ball_query``: the nearest, not pytorch3d's first in index
    order, ``docs/DEVIATIONS.md`` #3), k capped at the row's size.  Always
    exact, on K3: the version-1.0 sa steps ball-group rows of at most
    ``TABLE_MAX_N`` points, where the JAX package runs its exact search
    too; a larger row stays exact here rather than take a capped grid."""
    k = min(k, points.shape[1])
    return _k3.knn_search(query, points, q_valid, p_valid, k, float(radius))


def brute_knn(query, points, q_valid, p_valid, k: int, radius=None):
    """Exact masked kNN in any dimension, plain torch: squared distances
    expanded as |q|^2 + |p|^2 - 2 q.p (clamped at 0), as the JAX
    package's XLA search computes them, ties to the lower index; the
    output contract of :func:`knn`.  Serves the feature-space searches
    (dgcnn), which JAX runs outside Pallas too."""
    b, q, _ = query.shape
    n = points.shape[1]
    k = min(k, n)
    r2 = _k3._r2(radius)
    p_sq = (points * points).sum(-1)
    idx = torch.empty((b, q, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((b, q, k), dtype=torch.float32, device=query.device)
    step = max(1, (1 << 26) // max(b * n, 1))
    for lo in range(0, q, step):
        qc = query[:, lo:lo + step]
        d2 = ((qc * qc).sum(-1)[:, :, None] + p_sq[:, None, :]
              - 2.0 * (qc @ points.transpose(1, 2)))
        d2 = torch.where(p_valid[:, None, :], torch.clamp(d2, min=0.0),
                         torch.full_like(d2, float("inf")))
        best, order = torch.sort(d2, dim=-1, stable=True)
        best, order = best[..., :k], order[..., :k]
        good = ((best < float("inf")) & (best <= r2)
                & q_valid[:, lo:lo + step, None])
        idx[:, lo:lo + step] = torch.where(good, order,
                                           torch.full_like(order, -1)).int()
        dist[:, lo:lo + step] = torch.where(good, torch.sqrt(best),
                                            torch.full_like(best, INF))
    return idx, dist


def feature_knn(x, valid, k: int, radius=None):
    """The dgcnn graph: each valid point's k nearest valid points of its
    own row in the space of ``x`` (B, N, D), within ``radius`` if given
    (dgcnn-rad, k = 128).  A 3-D search (a position-only cloud) runs on
    K3, as the JAX package sends its 3-D searches to Pallas (a ball query
    exact, :func:`ball_query`); a wider one is :func:`brute_knn`."""
    if x.shape[-1] == 3:
        if radius is None:
            return knn(x, x, valid, valid, k)
        return ball_query(x, x, valid, valid, radius, k)
    return brute_knn(x, x, valid, valid, k, radius)


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
