"""K4 / K4b: the k-major row gather and its scatter-add.

Counterpart of ``curvecloudnet_tpu/ops/pallas_gather.py`` (``gather_rows``:
the ``_expand`` kernel forward, the ``_collapse`` kernel + unique-row
scatter backward).  On the TPU the gather routes each query tile's unique
rows through the MXU under a static per-tile budget (``UMAX``) that drops
rows past it; the port's gather is exact, as the JAX package's plain
branch is.  The CUDA kernels are ``csrc/gather.cu``; :func:`gather_km_ref`
and :func:`scatter_km_ref` are their plain PyTorch versions.  Each wrapper
runs the plain version for CPU tensors and the kernel for CUDA tensors.

src (B, N, C), idx (B, K, Q) with -1 fill -> (B, K, Q, C) = src[max(idx, 0)];
with ``fill`` the slots where idx < 0 read zeros and, in the backward,
add nothing.  A bfloat16 src (a model computing in bfloat16) is gathered
by :func:`gather_km_bf16`, rows of 2-byte elements, and its bfloat16
cotangents are summed by :func:`scatter_km_bf16`: float32 sums, rounded
to bfloat16 once, as the JAX package's ``_gather_bwd`` (f32 ``_collapse``
and scatter, then ``astype`` the source dtype).
"""

from __future__ import annotations

import torch

from . import _build
from .segments import take_rows


def gather_km_ref(src, idx, fill: bool = True):
    b, c = src.shape[0], src.shape[-1]
    out = take_rows(src, torch.clamp(idx, min=0).reshape(b, -1))
    out = out.reshape(idx.shape + (c,))
    if fill:
        out = torch.where((idx >= 0)[..., None], out, torch.zeros_like(out))
    return out


def scatter_km_ref(d_out, idx, n: int, fill: bool = True):
    """The gather's transpose: (B, K, Q, C) cotangents -> (B, N, C) in
    d_out's dtype, summed in float32 for bfloat16 cotangents."""
    b, c = d_out.shape[0], d_out.shape[-1]
    if fill:
        d_out = torch.where((idx >= 0)[..., None], d_out,
                            torch.zeros_like(d_out))
    rows = torch.clamp(idx, min=0).reshape(b, -1, 1).long().expand(-1, -1, c)
    wdt = torch.float32 if d_out.dtype == torch.bfloat16 else d_out.dtype
    out = torch.zeros((b, n, c), dtype=wdt, device=d_out.device)
    out.scatter_add_(1, rows, d_out.reshape(b, -1, c).to(wdt))
    return out.to(d_out.dtype)


def _check_idx(idx):
    if idx.dim() != 3:
        raise ValueError(f"gather: idx must be (B, K, Q), got {tuple(idx.shape)}")
    return idx.to(torch.int32).contiguous()


def gather_km(src, idx, fill: bool = True):
    """Kernel K4 for CUDA tensors (:func:`gather_km_bf16` for a bfloat16
    src), its plain version for CPU tensors."""
    if src.device.type == "cpu":
        return gather_km_ref(src, idx, fill)
    if src.dtype == torch.bfloat16:
        return gather_km_bf16(src, idx, fill)
    out = _gather(src, idx, fill, torch.float32)
    gather_km.launches += 1
    return out


def gather_km_bf16(src, idx, fill: bool = True):
    """Kernel K4's bfloat16 variant (rows of 2-byte elements), CUDA tensors
    only."""
    out = _gather(src, idx, fill, torch.bfloat16)
    gather_km_bf16.launches += 1
    return out


def _gather(src, idx, fill: bool, dtype):
    b, n, c = src.shape
    src = src.contiguous()
    idx = _check_idx(idx)
    _, k, q = idx.shape
    out = torch.empty((b, k, q, c), dtype=dtype, device=src.device)
    name = "ccn_gather_km" + ("_bf16" if dtype == torch.bfloat16 else "")
    rc = getattr(_build.library(), name)(
        _build.ptr(src, dtype, "src", 3),
        _build.ptr(idx, torch.int32, "idx", 3),
        out.data_ptr(), b, n, k * q, c, int(fill),
        _build.stream_ptr(src.device))
    _build.check(rc, name)
    return out


def scatter_km(d_out, idx, n: int, fill: bool = True):
    """Kernel K4b for CUDA tensors (:func:`scatter_km_bf16` for bfloat16
    cotangents), its plain version for CPU tensors."""
    if d_out.device.type == "cpu":
        return scatter_km_ref(d_out, idx, n, fill)
    if d_out.dtype == torch.bfloat16:
        return scatter_km_bf16(d_out, idx, n, fill)
    b, k, q, c = d_out.shape
    idx = _check_idx(idx)
    d_out = d_out.float().contiguous()
    out = torch.zeros((b, n, c), dtype=torch.float32, device=d_out.device)
    rc = _build.library().ccn_scatter_km(
        _build.ptr(d_out, torch.float32, "d_out", 4),
        _build.ptr(idx, torch.int32, "idx", 3),
        out.data_ptr(), b, n, k * q, c, int(fill),
        _build.stream_ptr(d_out.device))
    _build.check(rc, "ccn_scatter_km")
    scatter_km.launches += 1
    return out


def scatter_km_bf16(d_out, idx, n: int, fill: bool = True):
    """Kernel K4b's bfloat16 variant, CUDA tensors only: bfloat16
    cotangents (B, K, Q, C) summed into a float32 scratch, then rounded
    once -> (B, N, C) bfloat16."""
    b, k, q, c = d_out.shape
    idx = _check_idx(idx)
    d_out = d_out.contiguous()
    acc = torch.zeros((b, n, c), dtype=torch.float32, device=d_out.device)
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=d_out.device)
    rc = _build.library().ccn_scatter_km_bf16(
        _build.ptr(d_out, torch.bfloat16, "d_out", 4),
        _build.ptr(idx, torch.int32, "idx", 3),
        acc.data_ptr(), out.data_ptr(), b, n, k * q, c, int(fill),
        _build.stream_ptr(d_out.device))
    _build.check(rc, "ccn_scatter_km_bf16")
    scatter_km_bf16.launches += 1
    return out


gather_km.launches = 0
gather_km_bf16.launches = 0
scatter_km.launches = 0
scatter_km_bf16.launches = 0


class _GatherKM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx, fill):
        ctx.save_for_backward(idx)
        ctx.n, ctx.fill = src.shape[1], fill
        return gather_km(src, idx, fill)

    @staticmethod
    def backward(ctx, d_out):
        (idx,) = ctx.saved_tensors
        # d_src in the source's dtype (d_out carries it: the gather's
        # output has src's dtype)
        return scatter_km(d_out, idx, ctx.n, ctx.fill), None, None


def gather_rows_km(src, idx, fill: bool = True):
    """Differentiable k-major gather: K4 forward, K4b backward."""
    return _GatherKM.apply(src, idx, fill)
