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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .curve1d import window_concat_nomask


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
    """xe (B, n_exp, C0) f32; weights ((W, b), ...) with BN folded; used
    (B,) live slots.  Returns (B, n_exp, C_last)."""
    live = (torch.arange(xe.shape[1], device=xe.device)[None, :]
            < used[:, None].long())[..., None]
    a = xe
    for w, b in weights:
        y = F.leaky_relu(window_concat_nomask(a, half_k) @ w + b, 0.01)
        a = torch.where(live, y, torch.zeros_like(y))
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


def conv1d_chain_eval(xe, weights, used, half_k: int):
    """Kernel K1 for CUDA tensors, its plain version for CPU tensors."""
    if xe.device.type == "cpu":
        return conv1d_chain_eval_ref(xe, weights, used, half_k)
    b, n_exp, c0 = xe.shape
    dims = [c0]
    for w, bias in weights:
        if (w.shape[0] != (half_k + 1) * dims[-1]
                or bias.shape != (w.shape[1],)
                or (half_k + 1) * w.shape[1] > MAX_N):
            raise ValueError(f"conv1d chain: bad layer shapes {tuple(w.shape)}")
        dims.append(w.shape[1])
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


conv1d_chain_eval.launches = 0
