"""K6: the farthest-point-sampling pick loop.

Counterpart of ``curvecloudnet_tpu/ops/pallas_fps.py`` (the serial loop of
``fps_pallas``; its ascending sort and slot validity are in
``ops/sampling.fps``).  The CUDA kernel is ``csrc/fps.cu``;
:func:`fps_picks_ref` is its plain PyTorch version.  The wrapper runs the
plain version for CPU tensors and the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .segments import sq_norm3

_BIG = 1e30
MAX_N = 20 * 1024


def fps_picks_ref(pos, valid, start, budget: int):
    """pos (B, N, 3) f32, valid (B, N) bool, start (B,) -> (B, budget) int32
    pick order (ties to the lowest index)."""
    b = pos.shape[0]
    rows = torch.arange(b, device=pos.device)
    min_d2 = torch.where(valid, torch.full_like(pos[..., 0], _BIG),
                         torch.full_like(pos[..., 0], -_BIG))
    last = start.long()
    picks = torch.empty((b, budget), dtype=torch.int32, device=pos.device)
    for i in range(budget):
        picks[:, i] = last
        d2 = sq_norm3(pos - pos[rows, last][:, None, :])
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=-1)
    return picks


def fps_picks(pos, valid, start, budget: int):
    """Kernel K6 for CUDA tensors, its plain version for CPU tensors."""
    if pos.device.type == "cpu":
        return fps_picks_ref(pos, valid, start, budget)
    b, n, _ = pos.shape
    # positions in shared memory (12 B a point, beside ~1 KB of the
    # kernel's own); the min-distance field in registers, 20 a thread
    if n * 12 > _build.MAX_SMEM - 1024 or n > MAX_N:
        raise ValueError(f"fps kernel: a row of {n} points exceeds its "
                         f"shared memory or registers")
    start = start.to(torch.int32).contiguous()
    out = torch.empty((b, budget), dtype=torch.int32, device=pos.device)
    args = (
        _build.ptr(pos, torch.float32, "pos", 3),
        _build.ptr(valid, torch.bool, "valid", 2),
        _build.ptr(start, torch.int32, "start", 1),
        out.data_ptr(), b, n, budget, _build.stream_ptr(pos.device))
    rc = _build.library().ccn_fps(*args)
    _build.check(rc, "ccn_fps")
    fps_picks.launches += 1
    return out


fps_picks.launches = 0
