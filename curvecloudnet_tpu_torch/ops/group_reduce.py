"""K2: grouped message MLP + masked max / softmax-attend over K.

Counterpart of ``curvecloudnet_tpu/ops/pallas_group.py``
(``fused_group_reduce`` in its k-major form, ``fold_mlp_eval``,
``fold_full_mlp_eval``).  The CUDA kernel is ``csrc/group_reduce.cu``;
:func:`group_reduce_ref` is its plain PyTorch version, the materialized
composition the JAX package runs on CPU.  The wrapper runs the plain
version for CPU tensors and the kernel for CUDA tensors; the kernel runs
its dense layers in 3xTF32 on the tensor cores (each operand split as
:func:`tf32_split` does) over the live (query, plane) rows only.

h1 (B, K, M, C1) holds the layer-0 pre-norm messages, plane-major; mask
(B, M, K) is query-major with its columns in h1's plane order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .aggregate import masked_attend, masked_max

_ACT_CODES = {"relu": 0, "leaky_relu": 1, "identity": 2}


def _act(x, kind: str):
    if kind == "relu":
        return torch.clamp(x, min=0.0)
    if kind == "leaky_relu":
        return torch.where(x > 0, x, 0.01 * x)
    if kind == "identity":
        return x
    raise ValueError(kind)


def _dense(lin, bn=None):
    """(W (C_in, C_out), b) of a Linear, with an eval BN folded in."""
    w = lin.weight.t()
    b = lin.bias if lin.bias is not None else torch.zeros_like(w[0])
    if bn is not None:
        s, t = bn.affine()
        w, b = w * s[None, :], b * s + t
    return w, b


def fold_mlp_eval(mlp):
    """An eval MLP whose layer 0 runs outside the kernel -> (layer-0 BN
    affine (s, t), ((W, b) for layers 1..L-1)), hidden BNs folded.  A
    single-layer MLP folds to the identity affine and no layers."""
    n = len(mlp.lins)
    if n == 1:
        c = mlp.lins[0].out_features
        w = mlp.lins[0].weight
        return (torch.ones(c, device=w.device), torch.zeros(c, device=w.device)), ()
    layers = tuple(_dense(mlp.lins[i], mlp.norms[i] if i < mlp.n_norms else None)
                   for i in range(1, n))
    return mlp.norms[0].affine(), layers


def fold_full_mlp_eval(mlp):
    """A whole eval MLP (layer 0 included) -> ((W, b), ...), BNs folded."""
    return tuple(_dense(lin, mlp.norms[i] if i < mlp.n_norms else None)
                 for i, lin in enumerate(mlp.lins))


def _chain(h, layers, act: str):
    for i, (w, b) in enumerate(layers):
        h = h @ w + b
        if i < len(layers) - 1:
            h = _act(h, act)
    return h


def group_reduce_ref(h1, mask, affine0, local, attend=None, aggr="max",
                     act="relu", attend_act="leaky_relu"):
    """Returns (B, M, C_out) f32."""
    s0, t0 = affine0
    msg = _chain(_act(h1 * s0 + t0, act), local, act)        # (B, K, M, C)
    if aggr == "max":
        return masked_max(msg.transpose(1, 2), mask)
    logits = _chain(msg, attend, attend_act)
    return masked_attend(msg.transpose(1, 2), logits.transpose(1, 2), mask)


def tf32_round(x):
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as the card's ``cvt.rna.tf32.f32`` rounds: the f32 bits with
    half of the 13 dropped bits' unit added and those bits cleared.
    Infinities and NaNs pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x):
    """x -> (hi, lo), both TF32 values, hi = rna(x), lo = rna(x - hi): the
    split the kernel applies to each operand of its 3xTF32 products
    (lo*hi + hi*lo + hi*hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


# rows a chunk, widest first; weight rows a stage, most first; queries a
# block at most (curvecloudnet_tpu_torch/tools/k2_sweep.py sweeps rows and
# the query cap)
_ROWS = (64, 32, 16)
_STAGE_ROWS = (32, 16, 8)
_MAX_TQ = 64
# accumulators of a block (256 threads x 128): rows x the widest layer
_ACC = 32768


def _round(c: int, to: int) -> int:
    return -(-c // to) * to


def _smem_bytes(rows: int, tq: int, kc: int, k: int, dims, c_out: int,
                attend: bool) -> int:
    """Shared memory of a launch (``smem_bytes`` in the kernel source):
    two weight stages, the activations (and the messages under attend),
    the carried aggregation state and the row list."""
    ldx = _round(max(dims), 32) + 4
    ldw = _round(max(dims[1:], default=8), 32) + 8
    floats = (2 * kc * ldw + rows * ldx +
              (rows * (_round(c_out, 32) + 4) if attend else 0) +
              2 * (3 if attend else 1) * c_out)
    return 4 * floats + 4 * (3 * tq + 1) + 2 * tq * k


def _launch_shape(dims, c_out: int, attend: bool, k: int, queries: int,
                  sms: int):
    """(rows a chunk, queries a block, weight rows a stage): the widest
    chunk whose accumulators fit the registers and whose buffers fit the
    block's shared memory, with the deepest weight stage that still fits;
    at most _MAX_TQ queries a block, as many as fill whole waves of one
    block an SM (the buffers leave room for one)."""
    waves = -(-queries // (sms * _MAX_TQ))
    tq = -(-queries // (sms * waves))
    for rows in _ROWS:
        if _round(max(dims[1:], default=8), 8) * rows > _ACC:
            continue
        for kc in _STAGE_ROWS:
            if _smem_bytes(rows, tq, kc, k, dims, c_out,
                           attend) <= _build.MAX_SMEM:
                return rows, tq, kc
    raise ValueError(f"group kernel: width {max(dims)} too wide for shared "
                     "memory")


def pack_layers(layers, device):
    """((W, b), ...) -> (one f32 tensor, W offsets, bias offsets) as the
    chain kernel (``csrc/group_chain.cuh``) takes them: every layer's W
    row-major from a 16-byte boundary, then the biases."""
    parts = [torch.nn.functional.pad(w.detach().float().reshape(-1),
                                     (0, -w.numel() % 4)) for w, _ in layers]
    parts += [bias.detach().float().reshape(-1) for _, bias in layers]
    offsets = [0]
    for t in parts:
        offsets.append(offsets[-1] + t.numel())
    wp = torch.cat(parts) if layers else torch.zeros(1, device=device)
    return wp, offsets[:len(layers)], offsets[len(layers):-1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def group_reduce(h1, mask, affine0, local, attend=None, aggr="max",
                 act="relu", attend_act="leaky_relu"):
    """Kernel K2 for CUDA tensors, its plain version for CPU tensors."""
    if h1.device.type == "cpu":
        return group_reduce_ref(h1, mask, affine0, local, attend, aggr, act,
                                attend_act)
    if aggr not in ("max", "attend"):
        raise ValueError(f"group kernel aggregates max or attend, not {aggr}")
    b, k, m, c1 = h1.shape
    attend = tuple(attend or ()) if aggr == "attend" else ()
    layers = tuple(local) + attend
    dims = [c1]
    for w, bias in layers:
        if w.shape[0] != dims[-1] or bias.shape != (w.shape[1],):
            raise ValueError(f"group kernel: bad layer shapes {tuple(w.shape)}")
        dims.append(w.shape[1])
    c_out = dims[len(local)]
    if attend and dims[-1] != c_out:
        raise ValueError("group kernel: attention MLP must end at C_out")
    wp, woff, boff = pack_layers(layers, h1.device)
    s0 = affine0[0].float().contiguous()
    t0 = affine0[1].float().contiguous()
    rows, tq, kc = _launch_shape(dims, c_out, aggr == "attend", k, b * m,
                                 _sm_count(h1.device))
    out = torch.empty((b, m, c_out), dtype=torch.float32, device=h1.device)
    args = (
        _build.ptr(h1, torch.float32, "h1", 4),
        _build.ptr(mask, torch.bool, "mask", 3),
        _build.ptr(s0, torch.float32, "s0", 1),
        _build.ptr(t0, torch.float32, "t0", 1),
        _build.ptr(wp, torch.float32, "weights"),
        len(local), len(attend),
        _build.host_array(ctypes.c_int, dims),
        _build.host_array(ctypes.c_longlong, woff or [0]),
        _build.host_array(ctypes.c_longlong, boff or [0]),
        int(aggr == "attend"), _ACT_CODES[act], _ACT_CODES[attend_act],
        b, k, m, rows, tq, kc, out.data_ptr(), _build.stream_ptr(h1.device))
    rc = _build.library().ccn_group_reduce(*args)
    _build.check(rc, "ccn_group_reduce")
    group_reduce.launches += 1
    return out


group_reduce.launches = 0
