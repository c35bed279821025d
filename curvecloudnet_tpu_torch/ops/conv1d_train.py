"""K8: the conv1d-fast-v2 TRAIN chain over gap-expanded rows, with exact
masked BatchNorm batch statistics and exact gradients.

Counterpart of the train half of ``curvecloudnet_tpu/ops/pallas_conv1d.py``
(``conv1d_chain_train`` and its custom VJP over the passes
``_run_fwd_layer``, ``_run_bwd_reduce`` and ``_run_bwd_t``).  With
m(q) = [q < used] per sample and u_0 = xe, layer l computes

    z_l(q) = u_{l-1}(q) W_0 + sum_{d=1..h} (u_{l-1}(q-d) + u_{l-1}(q+d)) W_d + b
    u_l(q) = leaky(BN_l(z_l(q))) * m(q)

with u = 0 outside [0, n_exp) and BN_l normalizing with the mean and the
biased variance of z_l over the live slots of every sample (count
n = max(sum(used), 1)).  W ((h+1) C_in, C_out) holds tap d in row block d;
each layer's parameters are (W, b, gamma, beta).  The chain returns u_L and
the statistics (mean, var, n) of every layer.

Pass plan, as in the JAX package: the forward runs one pass per layer
(z_l and its statistics, applying layer l-1's BN, leaky and mask as it
loads z_{l-1}); the backward runs, per layer in reverse, a reduce pass (the
live-slot sums of dxh, dxh * xhat, da and da * xhat, where da = du * m *
leaky'(y), dxh = da * gamma) and a t pass (dz, the transposed window
product d_u_{l-1}, dW and db).  leaky'(0) = 1, as in the JAX kernel.  The
CUDA path takes layer l-1's reduce sums from layer l's t pass
(``prev_sums``) wherever layer l's input is at most DW_FUSED wide, so the
standalone reduce runs for the last layer and behind wider inputs only
(:func:`fused_reduce`).

The CUDA kernels are ``csrc/conv1d_train.cu``: the window products of the
forward and the t pass are 3xTF32 tensor-core products with the shifts on
the C_out-wide side (``csrc/conv_tc.cuh``; ``ops/conv_tc.py`` models them
on the CPU), the forward by tiles of :func:`fwd_tile` slots, the t pass's
d_u_prev by tiles of ROWS slots and its dW / db by the row splits of
:func:`dw_splits`.  :func:`conv1d_train_fwd_layer_ref`,
:func:`conv1d_train_bwd_reduce_ref` and :func:`conv1d_train_bwd_t_ref` are
their plain PyTorch versions, over the whole batch at once (the JAX
functions run one sample and sum; the forward returns finished statistics
in place of the raw sums).  :func:`conv1d_chain_train_ref` is the plain
chain, differentiated by torch autograd.  :class:`_Conv1dChainTrain` runs
the passes as a ``torch.autograd.Function`` (:func:`conv1d_chain_passes`);
:func:`conv1d_chain_train` takes it for CUDA tensors and the plain chain
for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .conv1d_chain import MAX_N, ROWS
from .curve1d import window_concat_nomask

EPS = 1e-5


def _live(used, n_exp: int, device) -> torch.Tensor:
    """m(q) as (B, n_exp, 1) f32."""
    q = torch.arange(n_exp, device=device)[None, :]
    return (q < used[:, None].long()).to(torch.float32)[..., None]


def _count(used) -> torch.Tensor:
    """n = max(sum(used), 1) as an f32 scalar tensor."""
    return torch.clamp(used.sum().to(torch.float32), min=1.0)


def _masked_moments(z, live, n):
    """Mean and biased variance of z over the live slots (two passes, as
    ``MaskedBatchNorm``)."""
    mean = (z * live).sum(dim=(0, 1)) / n
    return mean, ((z - mean) ** 2 * live).sum(dim=(0, 1)) / n


def _leaky(y):
    return torch.where(y >= 0, y, 0.01 * y)


def _dleaky(y):
    return torch.where(y >= 0, torch.ones_like(y), torch.full_like(y, 0.01))


def _affine(z, bn):
    """(xhat, y) of a BN given as (mean, inv, gamma, beta)."""
    mu, inv, gam, bet = bn
    xhat = (z - mu) * inv
    return xhat, xhat * gam + bet


def _u_of(z, bn, live):
    """A layer's input u from the previous layer's z, or z itself (xe) when
    there is no previous BN."""
    if bn is None:
        return z
    return _leaky(_affine(z, bn)[1]) * live


def conv1d_chain_train_ref(xe, params, used, half_k: int):
    """xe (B, n_exp, C0) f32, params ((W, b, gamma, beta), ...), used (B,).
    Returns (u_L (B, n_exp, C_L), ((mean, var, n), ...))."""
    live = _live(used, xe.shape[1], xe.device)
    n = _count(used)
    u, stats = xe, []
    for w, b, gam, bet in params:
        z = window_concat_nomask(u, half_k) @ w + b
        mean, var = _masked_moments(z, live, n)
        u = _leaky((z - mean) * torch.rsqrt(var + EPS) * gam + bet) * live
        stats.append((mean, var, n))
    return u, tuple(stats)


def conv1d_train_fwd_layer_ref(z_prev, bn_prev, w, b, used, half_k: int):
    """One forward pass: z_prev (B, n_exp, C_in) (xe on layer 1, with
    ``bn_prev`` None) and the previous layer's (mean, inv, gamma, beta) ->
    (z (B, n_exp, C_out), mean, var) with the statistics over live slots."""
    live = _live(used, z_prev.shape[1], z_prev.device)
    z = window_concat_nomask(_u_of(z_prev, bn_prev, live), half_k) @ w + b
    return (z, *_masked_moments(z, live, _count(used)))


def conv1d_train_bwd_reduce_ref(d_u, z, bn, used):
    """The reduce pass: live-slot sums (dxh, dxh * xhat, da, da * xhat),
    each (C,)."""
    live = _live(used, z.shape[1], z.device)
    xhat, y = _affine(z, bn)
    da = d_u * live * _dleaky(y)
    dxh = da * bn[2]
    return tuple(t.sum(dim=(0, 1)) for t in (dxh, dxh * xhat, da, da * xhat))


def conv1d_train_bwd_t_ref(d_u, z, z_prev, bn, bn_prev, w, c1, c2, used,
                           half_k: int, prev_sums: bool = False):
    """The t pass: dz = inv (dxh - m (c1 + xhat c2)) -> (d_u_prev
    (B, n_exp, C_in), dW ((h+1) C_in, C_out), db (C_out,)); with
    ``prev_sums`` also the previous layer's reduce sums over d_u_prev
    (:func:`conv1d_train_bwd_reduce_ref` of d_u_prev, z_prev, bn_prev)."""
    h = half_k
    live = _live(used, z.shape[1], z.device)
    _, inv, gam, _ = bn
    xhat, y = _affine(z, bn)
    da = d_u * live * _dleaky(y)
    dz = inv * (da * gam - live * (c1 + xhat * c2))
    c_in, c_out = z_prev.shape[-1], w.shape[1]
    w_t = w.reshape(h + 1, c_in, c_out).transpose(1, 2).reshape(-1, c_in)
    d_u_prev = window_concat_nomask(dz, h) @ w_t
    win = window_concat_nomask(_u_of(z_prev, bn_prev, live), h)
    dw = torch.einsum("bqi,bqo->io", win, dz)
    if prev_sums:
        return (d_u_prev, dw, dz.sum(dim=(0, 1)),
                conv1d_train_bwd_reduce_ref(d_u_prev, z_prev, bn_prev, used))
    return d_u_prev, dw, dz.sum(dim=(0, 1))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


# dW and db: inputs up to DW_FUSED channels wide are summed a ROWS-slot
# tile a block by the d_u_prev kernel; wider ones by about DW_BLOCKS blocks
# a call (m-chunks of DW_M input channels x row splits x samples), each its
# split's slots in stages of DW_STAGE (csrc/conv1d_train.cu TDF_MAX,
# TDW_M, TDW_ROWS)
DW_FUSED = 32
DW_BLOCKS = 256
DW_M = 64
DW_STAGE = 32


def fused_reduce(c_in: int) -> bool:
    """Whether the t pass of a layer whose input is ``c_in`` wide takes the
    previous layer's reduce sums (its dW is fused into the d_u_prev kernel,
    which holds d_u_prev and z_prev on chip); a rule of the shapes, which
    ``models.kernel_launches`` mirrors."""
    return c_in <= DW_FUSED


def fwd_tile(h: int) -> int:
    """Output slots of a forward block: ROWS less an h-slot halo each side."""
    return ROWS - 2 * h


def dw_splits(n_exp: int, c_in: int, bsz: int):
    """(splits, slots a split) of the t pass's weight gradient: the
    ROWS-slot tiles for inputs up to DW_FUSED wide, else rows of a sample
    cut into ranges of a multiple of DW_STAGE slots, so that about
    DW_BLOCKS blocks run; depends on the shapes only (a call's partials are
    summed in the same order every time)."""
    if c_in <= DW_FUSED:
        return -(-n_exp // ROWS), ROWS
    m_chunks = -(-c_in // DW_M)
    want = max(1, -(-DW_BLOCKS // (m_chunks * bsz)))
    rps = -(-n_exp // want)
    rps = -(-rps // DW_STAGE) * DW_STAGE
    return -(-n_exp // rps), rps


def _check(z_prev, w, half_k: int):
    if (z_prev.dim() != 3 or w.shape[0] != (half_k + 1) * z_prev.shape[-1]
            or (half_k + 1) * w.shape[1] > MAX_N or fwd_tile(half_k) < 1):
        raise ValueError(f"conv1d train kernel: input {tuple(z_prev.shape)} "
                         f"and W {tuple(w.shape)} with h={half_k}")


def _bn_pack(bn, c: int, device):
    """(mean, inv, gamma, beta) as one contiguous (4 C,) f32 tensor."""
    if bn is None:
        return None
    out = torch.cat([t.detach().reshape(-1).float() for t in bn]).contiguous()
    if out.numel() != 4 * c:
        raise ValueError(f"conv1d train kernel: BN of width {out.numel() // 4}"
                         f", want {c}")
    return out


def _vec_ptrs(vecs, c: int, name: str):
    """Device pointers of per-channel vectors (a BN's mean, inv, gamma,
    beta, ...) as the caller holds them, each (C,) f32 contiguous; four
    nulls for no BN."""
    if vecs is None:
        return [None] * 4
    out = []
    for i, t in enumerate(vecs):
        if t.numel() != c:
            raise ValueError(f"conv1d train kernel: {name}[{i}] of width "
                             f"{t.numel()}, want {c}")
        # a view of the caller's storage (no copy that the launch outlives)
        out.append(_build.ptr(t.detach(), torch.float32, f"{name}[{i}]", 1))
    return out


def conv1d_train_fwd_layer(z_prev, bn_prev, w, b, used, half_k: int):
    """K8's forward pass for CUDA tensors, its plain version for CPU
    tensors.  Returns what :func:`conv1d_train_fwd_layer_ref` returns."""
    if z_prev.device.type == "cpu":
        return conv1d_train_fwd_layer_ref(z_prev, bn_prev, w, b, used, half_k)
    _check(z_prev, w, half_k)
    bsz, n_exp, c_in = z_prev.shape
    c_out = w.shape[1]
    dev = z_prev.device
    tile = fwd_tile(half_k)
    n_tiles = -(-n_exp // tile)
    z_prev = z_prev.float().contiguous()
    wc = w.detach().float().contiguous()
    bc = b.detach().float().contiguous()
    used = used.to(torch.int32).contiguous()
    z = torch.empty((bsz, n_exp, c_out), device=dev)
    parts = torch.empty((bsz * n_tiles, 2 * c_out + 1), device=dev)
    mean = torch.empty(c_out, device=dev)
    var = torch.empty(c_out, device=dev)
    rc = _build.library().ccn_conv1d_train_fwd(
        _build.ptr(z_prev, torch.float32, "z_prev", 3),
        *_vec_ptrs(bn_prev, c_in, "bn_prev"),
        _build.ptr(wc, torch.float32, "w", 2),
        _build.ptr(bc, torch.float32, "b", 1),
        _build.ptr(used, torch.int32, "used", 1),
        z.data_ptr(), parts.data_ptr(), mean.data_ptr(), var.data_ptr(),
        bsz, n_exp, c_in, c_out, half_k, tile, _build.stream_ptr(dev))
    _build.check(rc, "ccn_conv1d_train_fwd")
    conv1d_train_fwd_layer.launches += 1
    return z, mean, var


def conv1d_train_bwd_reduce(d_u, z, bn, used):
    """K8's reduce pass for CUDA tensors, its plain version for CPU
    tensors.  Returns what :func:`conv1d_train_bwd_reduce_ref` returns."""
    if z.device.type == "cpu":
        return conv1d_train_bwd_reduce_ref(d_u, z, bn, used)
    bsz, n_exp, c = z.shape
    dev = z.device
    tile = 128
    n_tiles = -(-n_exp // tile)
    d_u = d_u.float().contiguous()
    z = z.float().contiguous()
    bnp = _bn_pack(bn, c, dev)
    used = used.to(torch.int32).contiguous()
    parts = torch.empty((bsz * n_tiles, 4 * c), device=dev)
    sums = torch.empty(4 * c, device=dev)
    rc = _build.library().ccn_conv1d_train_reduce(
        _build.ptr(d_u, torch.float32, "d_u", 3),
        _build.ptr(z, torch.float32, "z", 3),
        _build.ptr(bnp, torch.float32, "bn", 1),
        _build.ptr(used, torch.int32, "used", 1),
        parts.data_ptr(), sums.data_ptr(), bsz, n_exp, c, tile,
        _build.stream_ptr(dev))
    _build.check(rc, "ccn_conv1d_train_reduce")
    conv1d_train_bwd_reduce.launches += 1
    return tuple(sums.view(4, c).unbind(0))


def conv1d_train_bwd_t(d_u, z, z_prev, bn, bn_prev, w, c1, c2, used,
                       half_k: int, prev_sums: bool = False):
    """K8's t pass for CUDA tensors, its plain version for CPU tensors.
    Returns what :func:`conv1d_train_bwd_t_ref` returns; ``prev_sums``
    needs a previous BN and an input :func:`fused_reduce` admits."""
    if z.device.type == "cpu":
        return conv1d_train_bwd_t_ref(d_u, z, z_prev, bn, bn_prev, w, c1, c2,
                                      used, half_k, prev_sums)
    _check(z_prev, w, half_k)
    h = half_k
    bsz, n_exp, c_out = z.shape
    c_in = z_prev.shape[-1]
    if prev_sums and (bn_prev is None or not fused_reduce(c_in)):
        raise ValueError(f"conv1d train kernel: prev_sums needs a previous "
                         f"BN and an input at most {DW_FUSED} wide, got "
                         f"{c_in}")
    dev = z.device
    splits, rps = dw_splits(n_exp, c_in, bsz)
    d_u = d_u.float().contiguous()
    z = z.float().contiguous()
    z_prev = z_prev.float().contiguous()
    w_t = (w.detach().float().reshape(h + 1, c_in, c_out).transpose(1, 2)
           .contiguous())
    used = used.to(torch.int32).contiguous()
    n_dw = (h + 1) * c_in * c_out
    d_u_prev = torch.empty((bsz, n_exp, c_in), device=dev)
    # dz for the dW kernel of wide inputs
    dz = (torch.empty((bsz, n_exp, c_out), device=dev)
          if c_in > DW_FUSED else None)
    width = n_dw + c_out + (4 * c_in if prev_sums else 0)
    parts = torch.empty((bsz * splits, width), device=dev)
    sums = torch.empty(width, device=dev)
    rc = _build.library().ccn_conv1d_train_t(
        _build.ptr(d_u, torch.float32, "d_u", 3),
        _build.ptr(z, torch.float32, "z", 3),
        _build.ptr(z_prev, torch.float32, "z_prev", 3),
        *_vec_ptrs((*bn, c1, c2), c_out, "bn"),
        *_vec_ptrs(bn_prev, c_in, "bn_prev"),
        _build.ptr(w_t, torch.float32, "w_t", 3),
        _build.ptr(used, torch.int32, "used", 1),
        d_u_prev.data_ptr(), None if dz is None else dz.data_ptr(),
        parts.data_ptr(),
        sums.data_ptr(), bsz, n_exp, c_in, c_out, h, splits, rps,
        int(prev_sums), _build.stream_ptr(dev))
    _build.check(rc, "ccn_conv1d_train_t")
    conv1d_train_bwd_t.launches += 1
    out = (d_u_prev, sums[:n_dw].view(-1, c_out), sums[n_dw:n_dw + c_out])
    if prev_sums:
        return (*out, tuple(sums[n_dw + c_out:].view(4, c_in).unbind(0)))
    return out


conv1d_train_fwd_layer.launches = 0
conv1d_train_bwd_reduce.launches = 0
conv1d_train_bwd_t.launches = 0


def _bn_of(stats, params, li):
    mean, var = stats[2 * li], stats[2 * li + 1]
    return (mean, torch.rsqrt(var + EPS), params[li][2], params[li][3])


class _Conv1dChainTrain(torch.autograd.Function):
    """(u_L, n, mean_1, var_1, ...) = K8(xe; params) with gradients for xe
    and every parameter; the statistics are non-differentiable outputs
    (the JAX custom VJP ignores their cotangents)."""

    @staticmethod
    def forward(ctx, half_k, xe, used, *flat):
        params = [flat[i:i + 4] for i in range(0, len(flat), 4)]
        n = _count(used)
        zs, stats = [], []
        z_prev, bn_prev = xe, None
        for li, (w, b, _, _) in enumerate(params):
            z, mean, var = conv1d_train_fwd_layer(z_prev, bn_prev, w, b, used,
                                                  half_k)
            zs.append(z)
            stats += [mean, var]
            z_prev, bn_prev = z, _bn_of(stats, params, li)
        out = _u_of(z_prev, bn_prev, _live(used, xe.shape[1], xe.device))
        ctx.half_k, ctx.n_layers = half_k, len(params)
        ctx.save_for_backward(xe, used, n, *flat, *zs, *stats)
        ctx.mark_non_differentiable(n, *stats)
        return (out, n, *stats)

    @staticmethod
    def backward(ctx, d_out, *_):
        L, h = ctx.n_layers, ctx.half_k
        xe, used, n, *rest = ctx.saved_tensors
        flat, zs, stats = rest[:4 * L], rest[4 * L:5 * L], rest[5 * L:]
        params = [flat[i:i + 4] for i in range(0, 4 * L, 4)]
        d_u = d_out.contiguous()
        grads = [None] * (4 * L)
        sums = None  # layer li's reduce sums, when layer li + 1 took them
        for li in range(L - 1, -1, -1):
            bn = _bn_of(stats, params, li)
            z_prev, bn_prev = ((zs[li - 1], _bn_of(stats, params, li - 1))
                               if li > 0 else (xe, None))
            if sums is None:
                sums = conv1d_train_bwd_reduce(d_u, zs[li], bn, used)
            s_dxh, s_dxh_xh, s_da, s_da_xh = sums
            fuse = li > 0 and fused_reduce(z_prev.shape[-1])
            d_u, dw, db, *rest = conv1d_train_bwd_t(
                d_u, zs[li], z_prev, bn, bn_prev, params[li][0], s_dxh / n,
                s_dxh_xh / n, used, h, prev_sums=fuse)
            sums = rest[0] if fuse else None
            grads[4 * li:4 * li + 4] = [dw, db, s_da_xh, s_da]
        return (None, d_u, None, *grads)


def conv1d_chain_passes(xe, params, used, half_k: int):
    """The train chain through :class:`_Conv1dChainTrain` (each pass the
    kernel for CUDA tensors, its plain version for CPU tensors).  Returns
    what :func:`conv1d_chain_train_ref` returns."""
    out, n, *st = _Conv1dChainTrain.apply(
        half_k, xe, used, *[t for p in params for t in p])
    return out, tuple((st[2 * i], st[2 * i + 1], n)
                      for i in range(len(params)))


def conv1d_chain_train(xe, params, used, half_k: int):
    """The train chain through K8's passes for CUDA tensors, the plain chain
    (torch autograd) for CPU tensors."""
    if xe.device.type == "cpu":
        return conv1d_chain_train_ref(xe, params, used, half_k)
    return conv1d_chain_passes(xe, params, used, half_k)
