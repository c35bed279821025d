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

The CUDA kernels are ``csrc/edge_mlp.cu``, three launches a call: the
weights packed on the card (:func:`plan` lays out the image and the
launch, cached by shape); layer 0, linear in the message (with W_0 =
[Wt; Wb], h_0 W_0 = x_j (Wt - Wb) + x_i Wb), projected once a point,
[U | V] = x [Wt - Wb | Wb] + [0 | b_0] (:func:`layer0_projection` gives
those weights on the CPU); then K2's live-row chain
(``csrc/group_chain.cuh``) over the live (query, slot) rows, each
starting as relu(U[j] + V[i]) (U[j] + V[i] for a one-layer MLP), the
later layers in 3xTF32 on the tensor cores, the masked max per query.  The (N, K, C) neighbor planes and the (N, K, H)
layer outputs never reach device memory.  :func:`edge_model` and
:func:`projection_model` are the kernels' CPU model.

Like the Pallas kernel, K9 computes in float32 whatever x's dtype: a
bfloat16 x (a model computing in bfloat16) is exact in tf32, so the
projection of :func:`fused_edge_mlp_max_bf16` leaves out its lo part's
product, and the output is float32 and equal to float32 K9's on the
widened rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .aggregate import masked_max
from .group_reduce import (_launch_shape, _round, _sm_count, _smem_bytes,
                           fold_full_mlp_eval, tf32_split)
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
    """x (B, N, C) f32 or bf16 (widened to f32), nbr_idx (B, N, K) with -1
    padding -> (B, N, O) f32."""
    x = x.float()
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
    U[j] + V[i]; the values ``edge_pack_kernel`` packs (the CPU model's
    and the tests')."""
    w0, b0 = weights[0].detach().float(), biases[0].detach().float()
    return (torch.cat(layer0_split(w0), 1),
            torch.nn.functional.pad(b0, (w0.shape[1], 0)))


# the projection's tile (rows x output columns: EP_ROWS / EP_COLS of
# csrc/edge_mlp.cu), EP_BLOCKS blocks an SM, its weight stages' row stride
# (EP_LDW); its weight rows a stage, most first
_PROJ_ROWS, _PROJ_COLS, _PROJ_BLOCKS, _PROJ_LDW = 64, 128, 2, 136
_STAGE_ROWS = (32, 16, 8)
# the plan's fields in ``struct EmPlan``'s order (array fields by length)
PLAN_FIELDS = (("L", 1), ("dims", MAX_LAYERS + 1), ("c8", 1), ("ntile", 1),
               ("p_lo", 1), ("p_b", 1), ("kc", 1), ("p_smem", 1),
               ("woff", MAX_LAYERS), ("boff", MAX_LAYERS), ("w_first", 1),
               ("total", 1), ("rows", 1), ("tq", 1), ("ck", 1),
               ("per_sm", 1))


def _project_smem(c: int, kc: int) -> int:
    """Shared memory of a projection block: the tile's EP_ROWS rows of x
    (f32, row stride C rounded to 8 then to 32, + 4) and two weight stages
    of kc rows, each a hi and a lo image EP_LDW words wide."""
    ldx = _round(_round(c, 8), 32) + 4
    return 4 * (_PROJ_ROWS * ldx + 4 * kc * _PROJ_LDW)


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


@functools.lru_cache(maxsize=None)
def plan(c: int, dims: tuple, k: int, n: int, bsz: int, sms: int) -> dict:
    """The launch plan (``struct EmPlan``) of an edge MLP on x (bsz, n, c)
    with k slots and widths ``dims`` = (2C, H_0, ..., O): the image (layer
    0's projection weights, hi then lo, in tiles of EP_COLS columns, its
    bias; then each later layer's f32 W from a 16-byte boundary and their
    biases, as ``group_reduce.pack_layers`` lays them out), the
    projection's stage and the chain's launch shape (:func:`_chain_shape`).
    """
    n_layers = len(dims) - 1
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"edge kernel: {n_layers} layers")
    h0 = dims[1]
    p = {"L": n_layers, "dims": list(dims) + [0] * (MAX_LAYERS - n_layers),
         "c8": _round(c, 8), "ntile": -(-2 * h0 // _PROJ_COLS)}
    p["p_lo"] = p["ntile"] * p["c8"] * _PROJ_COLS
    p["p_b"] = 2 * p["p_lo"]
    p["kc"] = _project_stage(c)
    p["p_smem"] = _project_smem(c, p["kc"])
    off = p["w_first"] = p["p_b"] + p["ntile"] * _PROJ_COLS
    p["woff"], p["boff"] = [0] * MAX_LAYERS, [0] * MAX_LAYERS
    for l in range(1, n_layers):
        p["woff"][l] = off
        off += _round(dims[l] * dims[l + 1], 4)
    for l in range(1, n_layers):
        p["boff"][l] = off
        off += dims[l + 1]
    p["total"] = _round(off, 4)
    (p["rows"], p["tq"], p["ck"],
     p["per_sm"]) = _chain_shape(dims[1:], k, bsz * n, sms)
    return p


@functools.lru_cache(maxsize=None)
def _plan_ints(*key):
    """The plan as the host int array the C entry takes."""
    p = plan(*key)
    flat = []
    for name, count in PLAN_FIELDS:
        flat += list(p[name]) if count > 1 else [p[name]]
    return _build.host_array(ctypes.c_int, flat)


def fused_edge_mlp_max(x, nbr_idx, weights, biases):
    """Kernel K9 for CUDA tensors (:func:`fused_edge_mlp_max_bf16` for a
    bfloat16 x), its plain version for CPU tensors."""
    if x.device.type == "cpu":
        return fused_edge_mlp_max_ref(x, nbr_idx, weights, biases)
    if x.dtype == torch.bfloat16:
        return fused_edge_mlp_max_bf16(x, nbr_idx, weights, biases)
    out = _launch(x, nbr_idx, weights, biases)
    fused_edge_mlp_max.launches += 1
    return out


def fused_edge_mlp_max_bf16(x, nbr_idx, weights, biases):
    """Kernel K9 reading bfloat16 rows of x (float32 math and output), CUDA
    tensors only."""
    out = _launch(x, nbr_idx, weights, biases)
    fused_edge_mlp_max_bf16.launches += 1
    return out


def _operands(x, weights, biases, k: int):
    """(plan key, x contiguous, the weight and bias pointer arrays, one
    scratch: the image (16-byte aligned at 0) then [U | V]) of a call."""
    bsz, n, c = x.shape
    dims = [2 * c]
    for w, bias in zip(weights, biases):
        if w.shape[0] != dims[-1] or bias.shape != (w.shape[1],):
            raise ValueError(f"edge kernel: bad layer shapes {tuple(w.shape)}")
        dims.append(w.shape[1])
    key = (c, tuple(dims), k, n, bsz, _sm_count(x.device))
    p = plan(*key)
    ws = [w.detach().float().contiguous() for w in weights]
    bs = [b_.detach().float().contiguous() for b_ in biases]
    ptrs = (_build.host_array(ctypes.c_longlong,
                              [_build.ptr(w, torch.float32, "weights", 2)
                               for w in ws]),
            _build.host_array(ctypes.c_longlong,
                              [_build.ptr(b_, torch.float32, "biases", 1)
                               for b_ in bs]))
    scratch = torch.empty(p["total"] + bsz * n * 2 * dims[1],
                          device=x.device)
    return key, x.contiguous(), ptrs, (ws, bs), scratch


def _launch(x, nbr_idx, weights, biases):
    """The pack, the projection and the chain (``ccn_edge_mlp``)."""
    bsz, n, c = x.shape
    if nbr_idx.dim() != 3 or nbr_idx.shape[:2] != (bsz, n):
        raise ValueError(f"edge kernel: nbr_idx {tuple(nbr_idx.shape)} for "
                         f"x {tuple(x.shape)}")
    k = nbr_idx.shape[2]
    key, x, (wp, bp), _keep, scratch = _operands(x, weights, biases, k)
    bf16 = x.dtype == torch.bfloat16
    idx = nbr_idx.to(torch.int32).contiguous()
    out = torch.empty((bsz, n, key[1][-1]), dtype=torch.float32,
                      device=x.device)
    total = plan(*key)["total"]
    name = "ccn_edge_mlp_bf16" if bf16 else "ccn_edge_mlp"
    rc = getattr(_build.library(), name)(
        _build.ptr(x, torch.bfloat16 if bf16 else torch.float32, "x", 3),
        _build.ptr(idx, torch.int32, "nbr_idx", 3), wp, bp,
        scratch.data_ptr(), scratch[total:].data_ptr(), out.data_ptr(),
        bsz, n, k, c, _plan_ints(*key), _build.stream_ptr(x.device))
    _build.check(rc, name)
    return out


def projection(x, weights, biases):
    """Layer 0's projection of K9 on the card (``ccn_edge_project``: the
    pack and the projection of a call) -> [U | V] (B, N, 2 H_0) f32;
    :func:`projection_model` is its CPU model.  K9 runs it inside
    ``ccn_edge_mlp``; this entry serves its card test and the split of a
    call's time."""
    bsz, n, c = x.shape
    key, x, (wp, bp), _keep, scratch = _operands(x, weights, biases, 1)
    bf16 = x.dtype == torch.bfloat16
    total = plan(*key)["total"]
    name = "ccn_edge_project_bf16" if bf16 else "ccn_edge_project"
    rc = getattr(_build.library(), name)(
        _build.ptr(x, torch.bfloat16 if bf16 else torch.float32, "x", 3),
        wp, bp, scratch.data_ptr(), scratch[total:].data_ptr(), bsz, n, c,
        _plan_ints(*key), _build.stream_ptr(x.device))
    _build.check(rc, name)
    return scratch[total:].view(bsz, n, -1)


def projection_model(x, weights, biases, lo: bool = True):
    """K9's projection on the CPU in its order: [U | V] = x [Wt - Wb | Wb]
    + [0 | b_0] (:func:`layer0_projection`, the image's values), the
    weights split into tf32 (hi, lo) (``group_reduce.tf32_split``), x
    split as it loads, each 8-deep step adding (x_lo W_hi if ``lo``),
    x_hi W_lo and x_hi W_hi in turn into the f32 sums, then the bias.  A
    bfloat16-valued x has x_lo = 0, so ``lo=False`` (K9-bf16) gives the
    same sums bit for bit."""
    wproj, bproj = layer0_projection(weights, biases)
    xs = x.float().reshape(-1, x.shape[-1])
    xh, xl = tf32_split(xs)
    wh, wl = tf32_split(wproj)
    acc = torch.zeros(xs.shape[0], wproj.shape[1])
    for k in range(0, xs.shape[1], 8):
        if lo:
            acc = acc + xl[:, k:k + 8] @ wh[k:k + 8]
        acc = acc + xh[:, k:k + 8] @ wl[k:k + 8]
        acc = acc + xh[:, k:k + 8] @ wh[k:k + 8]
    return (acc + bproj).reshape(*x.shape[:-1], -1)


def edge_model(x, nbr_idx, weights, biases, sms: int = 2):
    """K9 on the CPU in its order -> (out (B, N, O), queries whose rows
    straddle two chunks): :func:`projection_model`; the chain's blocks of
    ``plan``'s tq queries strided over N, their live (query, slot) rows
    query-major in chunks of the plan's rows, each row U[j] + V[i] (then
    relu where later layers follow), each later layer a 3xTF32 product
    (x_lo W_hi + x_hi W_lo + x_hi W_hi), the masked max carried across a
    query's chunks from -100 (a dead slot) or -inf; a query with no live
    slot gets -100."""
    b, n, c = x.shape
    k = nbr_idx.shape[2]
    proj = projection_model(x, weights, biases, lo=x.dtype != torch.bfloat16)
    h0 = weights[0].shape[1]
    u, v = proj[..., :h0], proj[..., h0:]
    later = [(tf32_split(w.float()), bias.float())
             for w, bias in zip(weights[1:], biases[1:])]
    dims = (2 * c,) + tuple(w.shape[1] for w in weights)
    p = plan(c, dims, k, n, b, sms)
    tq, rows = p["tq"], p["rows"]
    blocks = -(-n // tq)
    live = nbr_idx >= 0
    out = torch.empty((b, n, dims[-1]))
    straddled = 0
    for bi in range(b):
        for m0 in range(blocks):
            qs = torch.arange(m0, n, blocks)[:tq]
            lv = live[bi, qs]
            out[bi, qs[~lv.any(1)]] = -100.0
            qq, kk = torch.nonzero(lv, as_tuple=True)     # query-major
            state = {}
            for r0 in range(0, len(qq), rows):
                q_c, k_c = qq[r0:r0 + rows], kk[r0:r0 + rows]
                i = qs[q_c]
                h = u[bi, nbr_idx[bi, i, k_c].long()] + v[bi, i]
                if later:
                    h = torch.clamp(h, min=0.0)
                for li, ((wh, wl), bias) in enumerate(later):
                    hh, hl = tf32_split(h)
                    h = hl @ wh + hh @ wl + hh @ wh + bias
                    if li < len(later) - 1:
                        h = torch.clamp(h, min=0.0)
                for q in torch.unique(q_c).tolist():
                    mine = h[q_c == q].amax(0)
                    if q in state:
                        straddled += 1
                        start = state[q]
                    elif bool(lv[q].all()):
                        start = torch.full_like(mine, -float("inf"))
                    else:
                        start = torch.full_like(mine, -100.0)
                    state[q] = torch.maximum(start, mine)
            for q, val in state.items():
                out[bi, qs[q]] = val
    return out, straddled


fused_edge_mlp_max.launches = 0
fused_edge_mlp_max_bf16.launches = 0
