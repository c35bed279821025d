"""Device time of one flagship train step by kernel and by K7 pass, and
the device's idle share (GPU, ``torch.profiler`` and CUDA events).

Builds the nuScenes flagship at n_pad 36864, B=1, trains on synthetic
sweep 0 with its labels (NLL + Lovász), runs one warm-up step, times one
step on the host clock, times every K7 pass launch of one step with CUDA
events, then profiles one more step with CPU and CUDA activities.  Run::

    python -m curvecloudnet_tpu_torch.tools.profile_train

Prints one JSON line (step wall, device busy time by group, idle share,
peak memory, K7 time by pass and by site), then the top device kernels.
"""

from __future__ import annotations

import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..ops import group_train
from ..train.__main__ import setup
from ..train.trainer import train_step

N_PAD = 36864
GROUPS = (("K7", "group_train"), ("K4", "gather_km"), ("K4b", "scatter_km"),
          ("K3", "knn_kernel"), ("K6", "fps_kernel"), ("gemm", "gemm"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model, opt, sched, loss_cfg, batch, gen = setup(
        "configs/nuscenes.yaml", dev, 0, N_PAD)

    def step() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(model, opt, sched(0), batch, gen, 0.1, loss_cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    step()
    torch.cuda.reset_peak_memory_stats()
    wall = step()
    peak = torch.cuda.max_memory_allocated()

    # every K7 pass of one step, timed with CUDA events
    events = []
    launch = group_train._launch

    def timed(counter, pass_, level, cfg, h1, *args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch(counter, pass_, level, cfg, h1, *args, **kw)
        b.record()
        events.append((pass_, f"{cfg.aggr} {cfg.dims} K={h1.shape[1]} "
                       f"M={h1.shape[2]}", a, b))

    group_train._launch = timed
    try:
        step()
    finally:
        group_train._launch = launch
    torch.cuda.synchronize()
    by_pass, by_site = {}, {}
    for pass_, site, a, b in events:
        ms = a.elapsed_time(b)
        by_pass[pass_] = by_pass.get(pass_, 0.0) + ms
        by_site[site] = by_site.get(site, 0.0) + ms

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = step()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    groups = {}
    for e in kern:
        g = next((g for g, s in GROUPS if s in e.key), "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "step_wall_ms": wall,
        "peak_memory_gib": peak / 2 ** 30, "busy_ms": busy,
        "by_group_ms": groups, "launches": sum(e.count for e in kern),
        "profiled_wall_ms": prof_wall,
        "idle_share_profiled": 1 - busy / prof_wall,
        "idle_share_estimate": 1 - busy / wall,
        "k7_ms_by_pass": by_pass, "k7_ms_by_site": by_site}))
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:110]}")


if __name__ == "__main__":
    main()
