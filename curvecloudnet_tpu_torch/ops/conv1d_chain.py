"""K1: the conv1d-fast-v2 eval chain over gap-expanded rows.

Counterpart of ``curvecloudnet_tpu/ops/pallas_conv1d.py``
(``conv1d_chain_eval``, ``fold_conv_bn_eval``).  The CUDA kernel is
``csrc/conv1d_chain.cu``: a block of ROWS slots runs the whole chain on
its tile of :func:`tile_rows` outputs and their halo, each layer one
3xTF32 tensor-core product of the input rows and the stacked taps
[W_0 | ... | W_h], shifted and pair-summed on the (h+1) C_out-wide side
(``csrc/conv_tc.cuh``; ``ops/conv_tc.py`` models it on the CPU).
:func:`conv1d_chain_eval_ref` is its plain PyTorch version, the JAX
package's exact path (window concat -> Dense -> leaky -> tail mask per
layer).  The wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors.

The chain computes in xe's dtype, as the Pallas kernel: a bfloat16 xe
(conv steps past the first of a model computing in bfloat16) has its
weights rounded to bfloat16, each symmetric pair a[i-d] + a[i+d] summed
and rounded in bfloat16, the products summed in float32, the bias, leaky
ReLU and live mask applied in float32 and every layer's output rounded to
bfloat16; :func:`conv1d_chain_eval_bf16` launches that variant
(``conv1d_chain_bf16_kernel`` in the same source: the pairs summed on the
input side, one bfloat16 product a tap; the taps packed once a call by
``conv1d_chain_bf16_pack_kernel`` into the image :func:`plan_bf16` lays
out; persistent blocks stream layer 0's input through a ring of
64-column chunks; ``ops/conv_tc.py`` ``chain_eval_model_bf16`` models
its order of sums on the CPU).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .curve1d import window_concat_nomask
from .group_reduce import round_to


def fold_conv_bn_eval(convs, norms, eps: float = 1e-5):
    """Fold each layer's symmetric taps + eval BatchNorm into one dense
    (W ((h+1)*C_in, C_out), b).  Taps are stored as the reference's
    (O, I, h+1) weight; row block d of W holds tap d."""
    out = []
    for conv, norm in zip(convs, norms):
        o, i, taps = conv.weight.shape
        w = conv.weight.permute(2, 1, 0).reshape(taps * i, o)
        s = norm.weight / torch.sqrt(norm.running_var + eps)
        t = norm.bias - norm.running_mean * s
        out.append((w * s[None, :], conv.bias * s + t))
    return tuple(out)


def conv1d_chain_eval_ref(xe, weights, used, half_k: int):
    """xe (B, n_exp, C0) f32 or bf16; weights ((W, b), ...) with BN folded;
    used (B,) live slots.  Returns (B, n_exp, C_last) in xe's dtype: in
    bfloat16 the pairs are summed in bfloat16, W rounded to it, products
    summed in float32 and each layer's output rounded to bfloat16."""
    live = (torch.arange(xe.shape[1], device=xe.device)[None, :]
            < used[:, None].long())[..., None]
    a = xe
    for w, b in weights:
        y = F.leaky_relu(window_concat_nomask(a, half_k).float()
                         @ round_to(w, xe.dtype) + b, 0.01)
        a = torch.where(live, y, torch.zeros_like(y)).to(xe.dtype)
    return a


# slots a block takes (csrc/conv_tc.cuh CV_ROWS) and the widest stacked
# product (h+1) C_out a layer may have (the kernels' accumulator tiles)
ROWS = 128
MAX_N = 96


def tile_rows(h: int, n_layers: int) -> int:
    """Output slots of a K1 block: its ROWS slots less the halo of h L
    slots each side."""
    tile = ROWS - 2 * h * n_layers
    if tile < 1:
        raise ValueError(f"conv1d chain: halo {h} x {n_layers} layers too wide "
                         f"for a {ROWS}-slot block")
    return tile


def _layer_dims(c0: int, weights, half_k: int, max_out: int):
    """[C_0, C_1, ...] of a chain whose layers ((h+1) C_in x C_out W, C_out
    bias) are checked, every C_out at most ``max_out``."""
    dims = [c0]
    for w, bias in weights:
        if (w.shape[0] != (half_k + 1) * dims[-1]
                or bias.shape != (w.shape[1],) or w.shape[1] > max_out):
            raise ValueError(f"conv1d chain: bad layer shapes {tuple(w.shape)}")
        dims.append(w.shape[1])
    return dims


def conv1d_chain_eval(xe, weights, used, half_k: int):
    """Kernel K1 for CUDA tensors (:func:`conv1d_chain_eval_bf16` for a
    bfloat16 xe), its plain version for CPU tensors."""
    if xe.device.type == "cpu":
        return conv1d_chain_eval_ref(xe, weights, used, half_k)
    if xe.dtype == torch.bfloat16:
        return conv1d_chain_eval_bf16(xe, weights, used, half_k)
    b, n_exp, c0 = xe.shape
    dims = _layer_dims(c0, weights, half_k, MAX_N // (half_k + 1))
    wp = torch.cat([t.reshape(-1).float() for wb in weights for t in wb])
    woff, boff, off = [], [], 0
    for w, bias in weights:
        woff.append(off)
        off += w.numel()
        boff.append(off)
        off += bias.numel()
    tile = tile_rows(half_k, len(weights))
    used = used.to(torch.int32).contiguous()
    out = torch.empty((b, n_exp, dims[-1]), dtype=torch.float32,
                      device=xe.device)
    args = (
        _build.ptr(xe, torch.float32, "xe", 3),
        _build.ptr(wp, torch.float32, "weights"),
        _build.ptr(used, torch.int32, "used", 1),
        out.data_ptr(), b, n_exp, half_k, len(weights),
        _build.host_array(ctypes.c_int, dims),
        _build.host_array(ctypes.c_longlong, woff),
        _build.host_array(ctypes.c_longlong, boff),
        tile, _build.stream_ptr(xe.device))
    rc = _build.library().ccn_conv1d_chain(*args)
    _build.check(rc, "ccn_conv1d_chain")
    conv1d_chain_eval.launches += 1
    return out


# the bfloat16 variant's widest layer output (csrc/conv1d_chain.cu
# CB_MAX_OUT), the columns of an input chunk (CB_KC), its deepest input
# ring (CB_MAX_STAGES) and the fields of its plan (struct CbPlan, in order;
# dims, toff and boff padded to the most layers)
MAX_OUT_BF16 = 128
CHUNK_BF16 = 64
MAX_STAGES_BF16 = 6
MAX_LAYERS = 8
PLAN_FIELDS = ("n_layers", "dims", "toff", "boff", "taps_words", "resident",
               "stages", "lda", "rows", "total", "x_off", "y_off", "ring_off",
               "smem")


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


def taps_words(cin: int, cout: int, half_k: int) -> int:
    """Words of one layer's taps in the image: (h+1) taps of cin rounded
    to 16 halved pair rows, each cout rounded to 8 plus 8 words (cb_taps'
    layout, ``csrc/conv_tc.cuh``)."""
    return (half_k + 1) * _ceil(cin, 16) // 2 * (_ceil(cout, 8) + 8)


def plan_bf16(dims, half_k: int) -> dict:
    """The bfloat16 chain's launch plan: the image's layout (every layer's
    taps at ``toff``, then the float32 biases at ``boff``, ``total``
    words), the tile (``rows`` slots, 2 ``rows`` threads a block: 256 where
    no layer is wider than 64, so 16 warps an SM share one copy of the
    taps) and the kernel's shared memory (byte offsets): the taps, the
    activation buffers X and Y (Y only past one layer) and the input ring.
    Every layer's taps stay resident where they fit beside a ring of its
    own (the next tile's chunks load during this tile's later layers);
    else, at 128 rows, the widest layer's taps are staged a layer at a time
    and the ring shares Y's room.  Chunks of ``CHUNK_BF16`` columns; the
    deepest ring that fits, up to ``MAX_STAGES_BF16``.  Raises where none
    fits."""
    taps = [taps_words(ci, co, half_k) for ci, co in zip(dims[:-1], dims[1:])]
    toff = [sum(taps[:i]) for i in range(len(taps))]
    boff, off = [], sum(taps)
    for co in dims[1:]:
        boff.append(off)
        off += _ceil(co, 4)
    lda = _ceil(max(dims[1:]), 16) + 8
    wide = lda - 8 > 64
    tries = ([] if wide else [(256, 1)]) + [(ROWS, 1), (ROWS, 0)]
    for rows, resident in tries:
        if rows - 2 * half_k * len(taps) < 1:
            continue
        words = sum(taps) if resident else max(taps)
        x = rows * lda * 2
        y = x if len(taps) > 1 else 0
        for stages in range(MAX_STAGES_BF16, 1, -1):
            ring = stages * rows * (CHUNK_BF16 + 8) * 2
            x_off = words * 4
            y_off = x_off + x
            ring_off = y_off + y if resident else y_off
            smem = ring_off + (ring if resident else max(ring, y))
            if smem <= _build.MAX_SMEM:
                return dict(n_layers=len(taps), dims=list(dims), toff=toff,
                            boff=boff, taps_words=words, resident=resident,
                            stages=stages, lda=lda, rows=rows,
                            total=off, x_off=x_off, y_off=y_off,
                            ring_off=ring_off, smem=smem)
    raise ValueError(f"conv1d chain: widths {list(dims)} too wide for shared "
                     "memory")


def plan_ints(plan: dict):
    """The plan as the kernel's ints (PLAN_FIELDS' order)."""
    out = []
    for f in PLAN_FIELDS:
        v = plan[f]
        if isinstance(v, list):
            n = MAX_LAYERS + 1 if f == "dims" else MAX_LAYERS
            out += v + [0] * (n - len(v))
        else:
            out.append(int(v))
    return out


def conv1d_chain_eval_bf16(xe, weights, used, half_k: int):
    """Kernel K1's bfloat16 variant (xe bfloat16, weights rounded to
    bfloat16, bfloat16 mma.sync with float32 sums, bfloat16 out), CUDA
    tensors only.  Two launches: the image's pack from the float32
    weights as they lie, then the chain."""
    b, n_exp, c0 = xe.shape
    dims = _layer_dims(c0, weights, half_k, MAX_OUT_BF16)
    if len(weights) > MAX_LAYERS:
        raise ValueError(f"conv1d chain: {len(weights)} layers, at most "
                         f"{MAX_LAYERS}")
    plan = plan_bf16(dims, half_k)
    layers = [(w.float().contiguous(), bias.float().contiguous())
              for w, bias in weights]
    tile = plan["rows"] - 2 * half_k * len(weights)
    used = used.to(torch.int32).contiguous()
    img = torch.empty(plan["total"], dtype=torch.int32, device=xe.device)
    out = torch.empty((b, n_exp, dims[-1]), dtype=torch.bfloat16,
                      device=xe.device)
    rc = _build.library().ccn_conv1d_chain_bf16(
        _build.ptr(xe, torch.bfloat16, "xe", 3),
        _build.host_array(ctypes.c_longlong, [
            _build.ptr(w, torch.float32, "weights") for w, _ in layers]),
        _build.host_array(ctypes.c_longlong, [
            _build.ptr(bias, torch.float32, "biases") for _, bias in layers]),
        _build.ptr(used, torch.int32, "used", 1),
        img.data_ptr(), out.data_ptr(), b, n_exp, half_k, tile,
        _build.host_array(ctypes.c_int, plan_ints(plan)),
        _build.stream_ptr(xe.device))
    _build.check(rc, "ccn_conv1d_chain_bf16")
    conv1d_chain_eval_bf16.launches += 1
    return out


conv1d_chain_eval.launches = 0
conv1d_chain_eval_bf16.launches = 0
