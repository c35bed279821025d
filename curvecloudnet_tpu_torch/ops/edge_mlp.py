"""K9: the sgcnn edge MLP fused with its masked max, in eval.

Counterpart of ``curvecloudnet_tpu/ops/pallas_edge.py``
(``fused_edge_mlp_max_single``, ``fold_batchnorm``,
``slow_order_transform``).  Per query i and neighbor slot k with
j = nbr_idx[i, k]:

    h_0 = [x_j, x_i - x_j]                       (2C wide)
    h_{l+1} = relu(h_l W_l + b_l)                hidden layers, eval BN folded
    msg = h_{L-1} W_{L-1} + b_{L-1}              the last dense is plain
    out_i = max_k (msg if j >= 0 else MAX_FILL)

The slow message order [x_i, x_j - x_i] is the fast one times
``slow_order_transform`` and folds into W_0 (:func:`fold_edge_mlp_eval`).
:func:`fused_edge_mlp_max_ref` is the plain PyTorch version (gather, concat,
MLP, masked max); the wrapper runs it for CPU tensors and the kernel for
CUDA tensors.

The CUDA kernel is ``csrc/edge_mlp.cu``.  Layer 0 is linear in the message:
with W_0 = [Wt; Wb], h_0 W_0 = x_j (Wt - Wb) + x_i Wb, so the kernel
projects every point once, [U | V] = x [Wt - Wb | Wb] + [0 | b_0]
(:func:`layer0_projection` packs those weights), and runs the edges on
K2's live-row chain (``csrc/group_chain.cuh``): each live (query, slot)
row starts as relu(U[j] + V[i]), the later layers run in 3xTF32 on the
tensor cores, and the masked max is taken per query.  The (N, K, C)
neighbor planes and the (N, K, H) layer outputs never reach device memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .aggregate import masked_max
from .group_reduce import (_launch_shape, _round, _sm_count, _smem_bytes,
                           fold_full_mlp_eval, pack_layers)
from .segments import take_rows

MAX_LAYERS = 8


def slow_order_transform(c: int, device=None) -> torch.Tensor:
    """(2C, 2C) map of the fast message [x_j, d] (d = x_i - x_j) to the slow
    one [x_i, x_j - x_i] = [x_j + d, -d]: T = [[I, 0], [I, -I]]."""
    eye = torch.eye(c, device=device)
    zero = torch.zeros((c, c), device=device)
    return torch.cat([torch.cat([eye, zero], 1), torch.cat([eye, -eye], 1)])


def fold_edge_mlp_eval(mlp, slow: bool = False):
    """An eval edge MLP (input width 2C) -> (weights, biases): hidden BNs
    folded into their dense (``group_reduce.fold_full_mlp_eval``, the
    contract of ``fold_batchnorm``), the last dense plain; ``slow`` folds
    the slow message order into W_0."""
    layers = fold_full_mlp_eval(mlp)
    weights = [w for w, _ in layers]
    if slow:
        weights[0] = slow_order_transform(weights[0].shape[0] // 2,
                                          weights[0].device) @ weights[0]
    return tuple(weights), tuple(b for _, b in layers)


def fused_edge_mlp_max_ref(x, nbr_idx, weights, biases):
    """x (B, N, C) f32, nbr_idx (B, N, K) with -1 padding -> (B, N, O)."""
    b, n, k = nbr_idx.shape
    c = x.shape[-1]
    xj = take_rows(x, torch.clamp(nbr_idx, min=0).reshape(b, -1).long())
    xj = xj.reshape(b, n, k, c)
    h = torch.cat([xj, x[:, :, None, :] - xj], dim=-1)
    for li, (w, bias) in enumerate(zip(weights, biases)):
        h = h @ w + bias
        if li < len(weights) - 1:
            h = torch.clamp(h, min=0.0)
    return masked_max(h, nbr_idx >= 0)


def layer0_split(w0):
    """W_0 = [Wt; Wb] (2C, H_0), which takes the message [x_j, x_i - x_j],
    -> (Wt - Wb, Wb): layer 0 of edge (i, j) is x_j (Wt - Wb) + x_i Wb +
    b_0.  The group route's two products and K9's projection both use it."""
    c = w0.shape[0] // 2
    return w0[:c] - w0[c:], w0[c:]


def layer0_projection(weights, biases):
    """Layer 0 of the edge MLP as one product a point: (C, 2 H_0) weights
    [Wt - Wb | Wb] (:func:`layer0_split`) and (2 H_0,) bias [0 | b_0]:
    x [Wt - Wb | Wb] + [0 | b_0] = [U | V], and layer 0 of edge (i, j) is
    U[j] + V[i]."""
    w0, b0 = weights[0].detach().float(), biases[0].detach().float()
    return (torch.cat(layer0_split(w0), 1),
            torch.nn.functional.pad(b0, (w0.shape[1], 0)))


# the projection's tile (rows x output columns, EP_ROWS / EP_COLS of
# csrc/edge_mlp.cu), EP_BLOCKS blocks an SM; its weight rows a stage, most
# first
_PROJ_ROWS, _PROJ_COLS, _PROJ_BLOCKS = 64, 128, 2
_STAGE_ROWS = (32, 16, 8)


def _project_smem(c: int, kc: int) -> int:
    """Shared memory of a projection block (two weight stages of kc rows,
    the tile's rows of x), as ``ccn_edge_mlp`` computes it."""
    ldx = _round(max(c, _PROJ_COLS), 32) + 4
    return 4 * (2 * kc * (_PROJ_COLS + 8) + _PROJ_ROWS * ldx)


def _project_stage(c: int) -> int:
    """Weight rows a stage of the projection: the most whose buffers let
    ``_PROJ_BLOCKS`` blocks share an SM."""
    for kc in _STAGE_ROWS:
        if (_PROJ_BLOCKS * (_project_smem(c, kc) + _build.BLOCK_RESERVED)
                <= _build.SM_SMEM):
            return kc
    raise ValueError(f"edge kernel: input {c} wide too wide for the "
                     "projection")


def _chain_shape(chain, k: int, queries: int, sms: int):
    """(rows a chunk, queries a block, weight rows a stage, blocks an SM) of
    the edge chain: K2's launch shape (``group_reduce._launch_shape``), but
    with 3 or 2 blocks an SM where every later layer is at most 64 or 128
    wide (their 64-row chunks need 1 or 2 accumulator tiles a warp, not 8,
    so the blocks' registers fit an SM together) and their shared memory
    fits, the queries a block set for full waves of those blocks."""
    wmax = _round(max(chain[1:], default=8), 8)
    for per_sm in (3 if wmax <= 64 else 2 if wmax <= 128 else 1, 1):
        rows, tq, kc = _launch_shape(chain, chain[-1], False, k, queries,
                                     sms * per_sm)
        smem = _smem_bytes(rows, tq, kc, k, chain, chain[-1], False)
        if per_sm == 1 or (rows == 64 and per_sm * (
                smem + _build.BLOCK_RESERVED) <= _build.SM_SMEM):
            return rows, tq, kc, per_sm


def fused_edge_mlp_max(x, nbr_idx, weights, biases):
    """Kernel K9 for CUDA tensors, its plain version for CPU tensors."""
    if x.device.type == "cpu":
        return fused_edge_mlp_max_ref(x, nbr_idx, weights, biases)
    bsz, n, c = x.shape
    if nbr_idx.dim() != 3 or nbr_idx.shape[:2] != (bsz, n):
        raise ValueError(f"edge kernel: nbr_idx {tuple(nbr_idx.shape)} for "
                         f"x {tuple(x.shape)}")
    k = nbr_idx.shape[2]
    dims = [2 * c]
    for w, bias in zip(weights, biases):
        if w.shape[0] != dims[-1] or bias.shape != (w.shape[1],):
            raise ValueError(f"edge kernel: bad layer shapes {tuple(w.shape)}")
        dims.append(w.shape[1])
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"edge kernel: {len(weights)} layers")
    wproj, bproj = layer0_projection(weights, biases)
    rest = tuple(zip(weights[1:], biases[1:]))
    chain = dims[1:]                      # H_0, then the later widths
    wp, woff, boff = pack_layers(rest, x.device)
    rows, tq, kc, per_sm = _chain_shape(chain, k, bsz * n,
                                        _sm_count(x.device))
    p_kc = _project_stage(c)
    x = x.float().contiguous()
    idx = nbr_idx.to(torch.int32).contiguous()
    proj = torch.empty((bsz, n, 2 * chain[0]), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((bsz, n, dims[-1]), dtype=torch.float32, device=x.device)
    rc = _build.library().ccn_edge_mlp(
        _build.ptr(x, torch.float32, "x", 3),
        _build.ptr(idx, torch.int32, "nbr_idx", 3),
        _build.ptr(wproj, torch.float32, "layer-0 weights", 2),
        _build.ptr(bproj, torch.float32, "layer-0 bias", 1),
        _build.ptr(wp, torch.float32, "weights"),
        proj.data_ptr(), out.data_ptr(), bsz, n, k, c, len(rest),
        _build.host_array(ctypes.c_int, chain),
        _build.host_array(ctypes.c_longlong, woff or [0]),
        _build.host_array(ctypes.c_longlong, boff or [0]),
        rows, tq, kc, per_sm, p_kc, _build.stream_ptr(x.device))
    _build.check(rc, "ccn_edge_mlp")
    fused_edge_mlp_max.launches += 1
    return out


fused_edge_mlp_max.launches = 0
