"""Device time of one eval scan by kernel, and the device's idle share
(GPU, ``torch.profiler``).

Builds a config's model (default the nuScenes flagship) at its ``n_pad``,
on a synthetic sweep of its dataset's sensor (B=1), or a batch of object
scans of its ``batch_size`` for an object config, serves two warm-up
scans, times one unprofiled scan on the host clock, then profiles one more
with CPU and CUDA activities.  Device busy time is the sum of
``self_device_time_total`` over the CUDA-side ``key_averages()`` entries.
Run::

    python -m curvecloudnet_tpu_torch.tools.profile_scan
    python -m curvecloudnet_tpu_torch.tools.profile_scan --config configs/kitti.yaml
    python -m curvecloudnet_tpu_torch.tools.profile_scan --config configs/audi.yaml
    python -m curvecloudnet_tpu_torch.tools.profile_scan --edge-kernel fused

Prints the busy time by group (K1-K6, K2-bf16, K9, cuBLAS gemm, other), the
profiled wall and its idle share (measured, profiler on), the unprofiled
wall and the idle share it implies (an estimate: busy time comes from the
profiled scan), then the top device kernels and host ops.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import predict as P

# K2 and K9 share the chain kernel (csrc/group_chain.cuh), told apart by
# its row source; K9's pack and projection (edge_pack, edge_project) by
# their prefix; K2's and K1's bfloat16 variants are kernels of their own
# (csrc/group_wgmma.cuh, conv1d_chain_bf16_kernel), reported apart
GROUPS = (("K2", "H1Src"), ("K2-bf16", "group_wgmma"), ("K9", "EdgeSrc"),
          ("K9", "edge_"), ("K3", "knn_"),
          ("K1-bf16", "conv1d_chain_bf16"), ("K1", "conv1d_chain"),
          ("K6", "fps_kernel"), ("K4", "gather_km"), ("K5", "grid_topk"),
          ("gemm", "gemm"))


def scan_ms(model, scan) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P.predict(model, *scan)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/nuscenes.yaml")
    ap.add_argument("--edge-kernel", default="group", choices=("group", "fused"),
                    help="the sgcnn steps' edge route")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scan: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    n_pad = P.n_pad_of(args.config)
    model = P.build_model(args.config, n_pad, dev,
                          edge_kernel=args.edge_kernel)
    scan = P.synthetic_inputs(args.config, 0, n_pad, dev)
    for _ in range(2):
        scan_ms(model, scan)
    plain_wall = scan_ms(model, scan)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = scan_ms(model, scan)
    ev = prof.key_averages()
    kern = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    groups = {}
    for e in kern:
        g = next((g for g, s in GROUPS if s in e.key), "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    print(json.dumps({
        "config": args.config, "n_pad": n_pad, "batch": scan[0].shape[0],
        "edge_kernel": args.edge_kernel,
        "device": torch.cuda.get_device_name(0), "busy_ms": busy,
        "by_group_ms": groups, "launches": sum(e.count for e in kern),
        "profiled_wall_ms": wall, "idle_share_profiled": 1 - busy / wall,
        "unprofiled_wall_ms": plain_wall,
        "idle_share_estimate": 1 - busy / plain_wall}))
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:30]:
        print(f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:110]}")
    for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"cpu {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
