"""K5: top-k within a radius over grid bucket rows, and K10: masked
k-smallest over the last axis.

Counterparts of ``curvecloudnet_tpu/ops/pallas_topk.py``
(``grid_topk_records`` and ``topk_smallest``).  The CUDA kernels are
``csrc/grid_topk.cu``; :func:`grid_topk_records_ref` and
:func:`topk_smallest_ref` are their plain PyTorch versions.  Each wrapper
runs the plain version for CPU tensors and the kernel for CUDA tensors.

Record table (built by ``ops/grid_knn.py``): ``table`` (R, cap, 4) f32,
one row of ``cap`` records [x, y, z, point index as int32 bits] per hash
bucket, filled from slot 0 (empty slots: index -1); ``counts`` (R,) int32
is each row's live prefix; ``nbr`` (Q, S) int32 names the table rows each
query reads, in stencil order.

Contract of both: ascending squared distances / values with their
indices, ties to the earlier column (for K5: candidate order (stencil
column, slot)), 1e30 / -1 fills.  Squared distances are (dx*dx + dy*dy) +
dz*dz of query - point, exact f32 (the Pallas kernels clear low mantissa
bits to pack their extraction words).
"""

from __future__ import annotations

import torch

from . import _build
from .segments import sq_norm3

INF = 1e30
MAX_K = 32
# query rows per chunk of the plain versions: ~2^24 candidates at a time
_CHUNK_ELEMS = 1 << 24


def candidate_planes(table, nbr, query, q_valid, r2: float, lo: int = 0,
                     hi: int | None = None):
    """Queries [lo, hi)'s (d2, idx) candidate planes, (c, S*cap) each, in
    (stencil column, slot) order; candidates that are empty, beyond r2 or
    of an invalid query read 1e30 (idx as stored)."""
    hi = query.shape[0] if hi is None else hi
    rec = table[nbr[lo:hi].long()]                       # (c, S, cap, 4)
    pid = rec[..., 3].view(torch.int32)
    d2 = sq_norm3(query[lo:hi, None, None, :] - rec[..., :3])
    good = (pid >= 0) & q_valid[lo:hi, None, None] & (d2 <= r2)
    d2 = torch.where(good, d2, torch.full_like(d2, INF))
    c = hi - lo
    return d2.reshape(c, -1), pid.reshape(c, -1)


def planes(table, nbr, query, q_valid, r2: float):
    """Every query's candidate planes (Q, S*cap), built chunk by chunk."""
    q, w = nbr.shape[0], nbr.shape[1] * table.shape[1]
    d2 = torch.empty((q, w), dtype=torch.float32, device=query.device)
    idx = torch.empty((q, w), dtype=torch.int32, device=query.device)
    step = max(1, _CHUNK_ELEMS // max(w, 1))
    for lo in range(0, q, step):
        hi = min(q, lo + step)
        d2[lo:hi], idx[lo:hi] = candidate_planes(table, nbr, query, q_valid,
                                                 r2, lo, hi)
    return d2, idx


def topk_smallest_ref(d, idx, k: int):
    q = d.shape[0]
    out_d = torch.empty((q, k), dtype=torch.float32, device=d.device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=d.device)
    step = max(1, _CHUNK_ELEMS // max(d.shape[1], 1))
    for lo in range(0, q, step):
        _store_smallest(d[lo:lo + step], idx[lo:lo + step], k,
                        out_d[lo:lo + step], out_i[lo:lo + step])
    return out_d, out_i


def _store_smallest(d, idx, k, out_d, out_i):
    """The k smallest of each row (stable: ties to the lower column) into
    the output slices; values not below 0.98e30 become the fill."""
    vals, order = torch.sort(d, dim=-1, stable=True)
    vals, order = vals[:, :k], order[:, :k]
    good = vals < INF * 0.98
    out_d.copy_(torch.where(good, vals, torch.full_like(vals, INF)))
    out_i.copy_(torch.where(good, torch.gather(idx, 1, order),
                            torch.full_like(order, -1, dtype=idx.dtype)))


def topk_smallest(d, idx, k: int):
    """Kernel K10 for CUDA tensors, its plain version for CPU tensors:
    per row of d (Q, W) f32, the k smallest values below 0.98e30 with
    their idx (Q, W) int32 -> (Q, k) each."""
    if d.device.type == "cpu":
        return topk_smallest_ref(d, idx, k)
    q, w = d.shape
    if not 1 <= k <= min(MAX_K, w):
        raise ValueError(f"topk_smallest takes 1 <= k <= min(32, W), got {k}")
    if idx.shape != d.shape:
        raise ValueError(f"idx {tuple(idx.shape)} != d {tuple(d.shape)}")
    out_d = torch.empty((q, k), dtype=torch.float32, device=d.device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=d.device)
    rc = _build.library().ccn_topk_smallest(
        _build.ptr(d, torch.float32, "d", 2),
        _build.ptr(idx, torch.int32, "idx", 2), q, w, k,
        out_d.data_ptr(), out_i.data_ptr(), _build.stream_ptr(d.device))
    _build.check(rc, "ccn_topk_smallest")
    topk_smallest.launches += 1
    return out_d, out_i


topk_smallest.launches = 0


def grid_topk_records_ref(table, counts, nbr, query, q_valid, k: int,
                          r2: float):
    """Plain version of K5: whole rows (the empty slots past ``counts``
    are masked, so the live prefixes are not needed), chunked over
    queries."""
    q, s = nbr.shape
    out_d = torch.empty((q, k), dtype=torch.float32, device=query.device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=query.device)
    step = max(1, _CHUNK_ELEMS // max(s * table.shape[1], 1))
    for lo in range(0, q, step):
        hi = min(q, lo + step)
        d2, pid = candidate_planes(table, nbr, query, q_valid, r2, lo, hi)
        _store_smallest(d2, pid, k, out_d[lo:hi], out_i[lo:hi])
    return out_d, out_i


def grid_topk_records(table, counts, nbr, query, q_valid, k: int, r2: float):
    """Kernel K5 for CUDA tensors, its plain version for CPU tensors:
    (d2 (Q, k) f32, idx (Q, k) int32) of each valid query's k nearest
    table records within squared radius ``r2`` (an f32 value)."""
    if table.device.type == "cpu":
        return grid_topk_records_ref(table, counts, nbr, query, q_valid, k, r2)
    q, s = nbr.shape
    rows, cap = table.shape[0], table.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"grid_topk_records takes 1 <= k <= {MAX_K}, got {k}")
    if table.dim() != 3 or table.shape[2] != 4 or counts.shape != (rows,):
        raise ValueError(f"table {tuple(table.shape)} / counts "
                         f"{tuple(counts.shape)}: expected (R, cap, 4) / (R,)")
    if query.shape != (q, 3) or q_valid.shape != (q,):
        raise ValueError(f"query {tuple(query.shape)} / q_valid "
                         f"{tuple(q_valid.shape)} do not match nbr {(q, s)}")
    out_d = torch.empty((q, k), dtype=torch.float32, device=query.device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=query.device)
    rc = _build.library().ccn_grid_topk(
        _build.ptr(table, torch.float32, "table", 3),
        _build.ptr(counts, torch.int32, "counts", 1),
        _build.ptr(nbr, torch.int32, "nbr", 2),
        _build.ptr(query, torch.float32, "query", 2),
        _build.ptr(q_valid, torch.bool, "q_valid", 1),
        q, s, cap, k, r2, out_d.data_ptr(), out_i.data_ptr(),
        _build.stream_ptr(query.device))
    _build.check(rc, "ccn_grid_topk")
    grid_topk_records.launches += 1
    return out_d, out_i


grid_topk_records.launches = 0
