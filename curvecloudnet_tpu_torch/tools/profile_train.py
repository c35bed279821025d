"""Device time of one train step by kernel and by K7 pass, and the
device's idle share (GPU, ``torch.profiler`` and CUDA events).

Builds a config's model at its n_pad (the nuScenes flagship at 36864 by
default) and its synthetic train batch (``train.__main__.setup``: a
sweep of its sensor at B=1, or object scans at its batch size) with its
task's loss, runs one warm-up step, times one step on the host clock,
times every K7 launch of one step with CUDA events (by pass and by
site), then profiles one more step with CPU and CUDA activities.  Run::

    python -m curvecloudnet_tpu_torch.tools.profile_train [--config configs/audi.yaml]

Prints one JSON line (step wall, device busy time by group, idle share,
peak memory, K7 time by pass and by site, and the device time and
launches of each kernel of K4, K4b and K8 apart), then the top device
kernels.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..ops import group_train
from ..train.__main__ import setup
from ..train.trainer import train_step

GROUPS = (("K7", "gt_gemm"), ("K7", "gt_finalize"), ("K7", "gt_aggregate"),
          ("K7", "gt_rowstats"), ("K8", "conv1d_train"), ("K4", "gather_km"),
          ("K4b", "scatter_km"), ("K3", "knn_"), ("K6", "fps_kernel"),
          ("K5", "grid_topk"), ("gemm", "gemm"))
# kernels whose device time is printed one by one: K4, K4b, K8's passes
APART = ("gather_km", "scatter_km", "conv1d_train")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/nuscenes.yaml")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model, opt, sched, loss_cfg, batch, gen = setup(args.config, dev, 0)

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

    # every K7 launch of one step, timed with CUDA events, by pass and by
    # site (the call of the wrapper around it)
    with group_train.launch_times() as times:
        step()
    by_pass, by_site = {}, {}
    for (pass_, where), ms in times.items():
        by_pass[pass_] = by_pass.get(pass_, 0.0) + ms
        by_site[where] = by_site.get(where, 0.0) + ms

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = step()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    groups = {}
    for e in kern:
        g = next((g for g, s in GROUPS if s in e.key), "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    apart = {e.key.split("(")[0]: {
        "device_ms": e.self_device_time_total / 1e3, "launches": e.count}
        for e in kern if any(n in e.key for n in APART)}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "config": args.config,
        "batch": int(batch.cloud.valid.shape[0]), "step_wall_ms": wall,
        "peak_memory_gib": peak / 2 ** 30, "busy_ms": busy,
        "by_group_ms": groups, "launches": sum(e.count for e in kern),
        "profiled_wall_ms": prof_wall,
        "idle_share_profiled": 1 - busy / prof_wall,
        "idle_share_estimate": 1 - busy / wall,
        "k7_ms_by_pass": by_pass, "k7_ms_by_site": by_site,
        "kernels_apart": apart}))
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:110]}")


if __name__ == "__main__":
    main()
