"""Sweep K6's launch shape at the main path's fps rows (GPU).

K6 (``csrc/fps.cu``) runs a row on one CTA of T threads, P points a
thread (``fps.launch_config`` takes 256 threads).  For each fps row of the
nuScenes and KITTI forwards (row
size, valid points, picks as ``chip_smoke.py`` phases 3 and 9 print them),
on a lidar-like row of the port's synthetic sweep (valid points first, in
scan order), every shape the kernel takes is checked against the plain
version (picks equal) and timed with CUDA events (median of 5), beside its
fixed cost: the same shape on a 1024-point row of random points, all
valid, with the same picks up to 1024.  Run::

    python -m curvecloudnet_tpu_torch.tools.fps_sweep

Prints one JSON line per (row, shape): ``{"n", "valid", "picks", "T",
"P", "ms", "us_pick", "fixed_us_pick"}``, then the best shape a row.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..data.synthetic import lidar_sweep
from ..ops import fps

# (row size, valid points, picks): nuScenes 5760 and 1728, KITTI 18432 and
# 5530 (chip_smoke.py phases 3 and 9)
ROWS = [(5760, 3019, 1728), (1728, 906, 519), (18432, 4140, 5530),
        (5530, 1242, 1659)]
THREADS = (32, 64, 128, 256, 512, 1024)


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def row(n, n_valid, dev, seed=0):
    rng = np.random.default_rng(seed)
    pts = lidar_sweep(rng, 2 * n_valid, 32)[0]
    pts = pts[np.sort(rng.permutation(len(pts))[:n_valid])]
    pos = np.zeros((1, n, 3), np.float32)
    pos[0, :n_valid] = pts
    valid = np.zeros((1, n), bool)
    valid[0, :n_valid] = True
    return (torch.from_numpy(pos).to(dev), torch.from_numpy(valid).to(dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def shapes(n):
    """At each CTA width, the fewest points a thread the kernel is built
    for that cover the row, where there are enough."""
    for t in THREADS:
        p = next((p for p, most in fps._POINTS.items()
                  if t <= most and p * t >= n), None)
        if p is not None:
            yield t, p


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fps_sweep: needs a CUDA device")
    dev = torch.device("cuda")
    for n, n_valid, picks in ROWS:
        args = row(n, n_valid, dev)
        g = torch.Generator(device=dev).manual_seed(1)
        small = (torch.randn((1, 1024, 3), generator=g, device=dev),
                 torch.ones((1, 1024), dtype=torch.bool, device=dev),
                 args[2])
        few = min(picks, 1024)
        want = fps.fps_picks_ref(*args, picks)
        best = None
        for cfg in shapes(n):
            got = fps.fps_picks_config(*args, picks, cfg)
            if not torch.equal(got, want):
                raise AssertionError(f"fps {cfg} at n={n}: picks differ")
            ms = cuda_ms(lambda: fps.fps_picks_config(*args, picks, cfg))
            fixed = cuda_ms(lambda: fps.fps_picks_config(*small, few, cfg))
            line = {"n": n, "valid": n_valid, "picks": picks, "T": cfg[0],
                    "P": cfg[1], "ms": ms,
                    "us_pick": ms * 1e3 / picks,
                    "fixed_us_pick": fixed * 1e3 / few}
            print(json.dumps(line), flush=True)
            if best is None or ms < best["ms"]:
                best = line
        print(json.dumps({"best": best, "launch_config":
                          fps.launch_config(n)}), flush=True)


if __name__ == "__main__":
    main()
