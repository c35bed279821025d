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
The CUDA kernel is ``csrc/edge_mlp.cu``; it reads the rows x_j itself
through nbr_idx, so the (N, K, C) neighbor planes never reach device
memory.  :func:`fused_edge_mlp_max_ref` is its plain PyTorch version
(gather, concat, MLP, masked max).  The wrapper runs the plain version for
CPU tensors and the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .aggregate import masked_max
from .group_reduce import fold_full_mlp_eval
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


def _pick_tq(c: int, dims, k: int) -> int:
    """Queries a block takes: the largest tile whose two activation buffers
    (rows of the widest activation, csrc/edge_mlp.cu) leave room for two
    blocks per SM, else the largest that fits."""
    wmax = max((c,) + tuple(dims[1:]))
    for budget in (_build.MAX_SMEM // 2, _build.MAX_SMEM):
        for tq in (8, 4, 2, 1):
            if 4 * (2 * tq * k * wmax + tq * c + tq * k) <= budget:
                return tq
    raise ValueError(f"edge kernel: widths {dims} with K={k} too wide for "
                     "shared memory")


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
    tq = _pick_tq(c, dims, k)
    wp = torch.cat([t.detach().reshape(-1).float()
                    for wb in zip(weights, biases) for t in wb])
    woff, boff, off = [], [], 0
    for w, bias in zip(weights, biases):
        woff.append(off)
        off += w.numel()
        boff.append(off)
        off += bias.numel()
    x = x.float().contiguous()
    idx = nbr_idx.to(torch.int32).contiguous()
    out = torch.empty((bsz, n, dims[-1]), dtype=torch.float32, device=x.device)
    rc = _build.library().ccn_edge_mlp(
        _build.ptr(x, torch.float32, "x", 3),
        _build.ptr(idx, torch.int32, "nbr_idx", 3),
        _build.ptr(wp, torch.float32, "weights"),
        out.data_ptr(), bsz, n, k, c, len(weights),
        _build.host_array(ctypes.c_int, dims),
        _build.host_array(ctypes.c_longlong, woff),
        _build.host_array(ctypes.c_longlong, boff),
        tq, _build.stream_ptr(x.device))
    _build.check(rc, "ccn_edge_mlp")
    fused_edge_mlp_max.launches += 1
    return out


fused_edge_mlp_max.launches = 0
