"""K3: exact masked kNN (k <= 128) with an optional radius.

Counterpart of ``curvecloudnet_tpu/ops/pallas_knn.py`` (``knn_pallas``) and
of the exact search the JAX package runs on CPU (``ops/neighbors.knn``).
The CUDA kernel is ``csrc/knn.cu``; :func:`knn_search_ref` is its plain
PyTorch version.  The wrapper runs the plain version for CPU tensors and
the kernel for CUDA tensors.

Contract: for each valid query, the k nearest valid points with squared
distance <= radius^2, ascending, ties to the lower index; idx (B, Q, k)
int32 with -1 fill, dist (B, Q, k) f32 Euclidean with 1e30 fill.
Squared distances are (dx*dx + dy*dy) + dz*dz of direct differences (the
JAX CPU path expands |q|^2 + |p|^2 - 2 q.p, so near-ties can order
differently there).  Up to k = 32 the kernel keeps a query's list in one
register a lane; past it (the ball queries, k = 128) in ceil(k / 32)
rounded up to 2 or 4.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .segments import sq_norm3, sqrt32

INF = 1e30
MAX_K = 128
TILE = 32    # points a tile of csrc/knn.cu (one a lane of a warp)
MAX_N = 256 * 32 * TILE   # 256 super-tiles of 32 tiles
# csrc/knn.cu's brute-force route is launched beside the tiled search for
# calls of k <= BRUTE_MAX_K and at least BRUTE_MIN_Q queries; a row whose
# tile boxes fill at least BRUTE_SPREAD of their super-tile's box on
# average (no scan-order locality) takes it.  Smaller calls keep the tiled
# search, which fills the card with fewer queries.
BRUTE_MAX_K = 8
BRUTE_MIN_Q = 16384
BRUTE_SPREAD = 0.2


def _r2(radius) -> float:
    """radius^2 rounded to f32, as the JAX package compares it."""
    return float("inf") if radius is None else float(np.float32(radius * radius))


# query rows per chunk of the plain version: ~2^26 distances at a time
_CHUNK_ELEMS = 1 << 26


def knn_search_ref(query, points, q_valid, p_valid, k: int, radius=None):
    b, q, _ = query.shape
    n = points.shape[1]
    r2 = _r2(radius)
    idx = torch.empty((b, q, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((b, q, k), dtype=torch.float32, device=query.device)
    step = max(1, _CHUNK_ELEMS // max(n * b, 1))
    for lo in range(0, q, step):
        qc = query[:, lo:lo + step]
        d2 = sq_norm3(qc[:, :, None, :] - points[:, None, :, :])   # (B, c, N)
        keep = p_valid[:, None, :] & (d2 <= r2)
        d2 = torch.where(keep, d2, torch.full_like(d2, float("inf")))
        best, order = torch.sort(d2, dim=-1, stable=True)
        best, order = best[..., :k], order[..., :k]
        good = (best < float("inf")) & q_valid[:, lo:lo + step, None]
        idx[:, lo:lo + step] = torch.where(good, order,
                                           torch.full_like(order, -1)).int()
        dist[:, lo:lo + step] = torch.where(good, sqrt32(best),
                                            torch.full_like(best, INF))
    return idx, dist


def _launch(query, points, q_valid, p_valid, k: int, radius, visits):
    """Kernel K3 on CUDA tensors -> (idx, dist); ``visits`` a zeroed (2,)
    int64 tensor the kernel adds its tile counts to, or None."""
    b, q, _ = query.shape
    n = points.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn kernel takes 1 <= k <= {MAX_K}, got {k}")
    if n > MAX_N:
        raise ValueError(f"knn kernel takes rows of at most {MAX_N} points, "
                         f"got {n}")
    tiles = -(-n // TILE)
    # the pre-pass's scratch, one buffer: points packed as (x, y, z,
    # valid), the boxes of tiles and of super-tiles of 32 tiles (float4s)
    sizes = (b * tiles * TILE, b * tiles * 2, b * -(-tiles // 32) * 2)
    scratch = torch.empty((sum(sizes), 4), dtype=torch.float32,
                          device=query.device)
    packed = scratch.data_ptr()
    boxes = packed + 16 * sizes[0]
    supers = boxes + 16 * sizes[1]
    idx = torch.empty((b, q, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((b, q, k), dtype=torch.float32, device=query.device)
    args = (
        _build.ptr(query, torch.float32, "query", 3),
        _build.ptr(points, torch.float32, "points", 3),
        _build.ptr(q_valid, torch.bool, "q_valid", 2),
        _build.ptr(p_valid, torch.bool, "p_valid", 2),
        b, q, n, k, _r2(radius), int(k <= BRUTE_MAX_K and q >= BRUTE_MIN_Q),
        packed, boxes, supers, idx.data_ptr(),
        dist.data_ptr(),
        None if visits is None else visits.data_ptr(),
        _build.stream_ptr(query.device))
    rc = _build.library().ccn_knn(*args)
    _build.check(rc, "ccn_knn")
    return idx, dist


def knn_search(query, points, q_valid, p_valid, k: int, radius=None):
    """Kernel K3 for CUDA tensors, its plain version for CPU tensors."""
    if query.device.type == "cpu":
        return knn_search_ref(query, points, q_valid, p_valid, k, radius)
    out = _launch(query, points, q_valid, p_valid, k, radius, None)
    knn_search.launches += 1
    return out


knn_search.launches = 0


def tile_visits(query, points, q_valid, p_valid, k: int, radius=None):
    """(tiles visited, tiles the valid queries could visit) of one kernel
    run on these CUDA inputs, summed over the queries: the share of the
    sweep the boxes did not prove useless."""
    visits = torch.zeros(2, dtype=torch.int64, device=query.device)
    _launch(query, points, q_valid, p_valid, k, radius, visits)
    seen, total = visits.tolist()
    return seen, total
