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
# launch shapes (csrc/fps.cu): the points a thread the kernel is built for
# and the most threads a CTA each takes; the threads a CTA of the wrapper
# (tools/fps_sweep.py)
_POINTS = {1: 1024, 2: 1024, 4: 1024, 8: 1024, 12: 512, 16: 512, 24: 256,
           32: 256, 76: 256}
_THREADS = 256
# a row's points in shared memory at 12 B, beside the kernel's 640 B
SMEM_N = (_build.MAX_SMEM - 1024) // 12
# larger rows take the 48-point build on 512 threads, which holds in
# shared memory only the points past a thread's first 12 (A2D2's
# 23040-point fps row)
_BIG_P, _BIG_T = 48, 512
MAX_N = _BIG_P * _BIG_T


def smem_bytes(n: int, t: int, p: int) -> int:
    """Shared memory of a launch, as ``csrc/fps.cu`` sizes it (its 128 B of
    static warp counts included)."""
    if p == _BIG_P:
        r0 = 12 * t
        return 1536 + max(12 * max(r0, n - r0), 4 * n) + 128
    return 512 + 12 * n + 128


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


def launch_config(n: int):
    """(T threads, P points a thread) of a row of ``n`` points: one CTA of
    ``_THREADS``, the fewest points a thread that cover the row and whose
    shared memory fits; past those, the 48-point build on 512 threads."""
    if n > MAX_N:
        raise ValueError(f"fps kernel: a row of {n} points exceeds its "
                         f"registers and shared memory (at most {MAX_N})")
    t = _THREADS
    return next(((t, p) for p, most in _POINTS.items()
                 if t <= most and p * t >= n
                 and smem_bytes(n, t, p) <= _build.MAX_SMEM),
                (_BIG_T, _BIG_P))


def fps_picks_config(pos, valid, start, budget: int, config):
    """Kernel K6 with the launch shape ``config`` = (T, P) (CUDA tensors);
    :func:`fps_picks` takes :func:`launch_config`'s."""
    t, p = config
    b, n, _ = pos.shape
    start = start.to(torch.int32).contiguous()
    out = torch.empty((b, budget), dtype=torch.int32, device=pos.device)
    args = (
        _build.ptr(pos, torch.float32, "pos", 3),
        _build.ptr(valid, torch.bool, "valid", 2),
        _build.ptr(start, torch.int32, "start", 1),
        out.data_ptr(), b, n, budget, t, p,
        _build.stream_ptr(pos.device))
    rc = _build.library().ccn_fps(*args)
    _build.check(rc, "ccn_fps")
    return out


def fps_picks(pos, valid, start, budget: int):
    """Kernel K6 for CUDA tensors, its plain version for CPU tensors."""
    if pos.device.type == "cpu":
        return fps_picks_ref(pos, valid, start, budget)
    out = fps_picks_config(pos, valid, start, budget,
                           launch_config(pos.shape[1]))
    fps_picks.launches += 1
    return out


fps_picks.launches = 0
