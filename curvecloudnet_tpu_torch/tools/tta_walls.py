"""TTA scan walls on the GPU: the eval loop over synthetic val scans,
per view and at several views a call, and the host waits and device busy
time of one TTA scan.

Builds a config's model through ``main.build`` (random weights, seed 0)
at its n_pad and its synthetic val scans (``main.load_datasets``, seed
2).  For each ``--views`` setting (1: the per-view forward and its post;
v: ``make_batched_tta_eval`` at v views a call): ``evaluate_segmentation``
over a warm-up scan and ``--scans`` more, which reports the TTA scan wall
(``scan_wall_s``), points/s and the peak memory; then, on one scan staged
on the card, after a first call, the host waits under
``torch.cuda.set_sync_debug_mode``, by the line that made them, and the
device busy ms under ``torch.profiler``, by kernel group
(``profile_scan.GROUPS``), with the idle share of that scan.  Run from the repository root, in turns with another tree's copy to
compare two commits::

    python -m curvecloudnet_tpu_torch.tools.tta_walls [--config configs/kitti.yaml] [--scans 3] [--views 1 2 6]

Prints one JSON line a setting: the card and its power limit, ms a view,
the scan's TTA wall, points/s, peak memory (GB), the host waits and the
profiled scan's busy ms by group.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import main as M
from ..config import load_config
from ..data import datasets as D
from ..run import tasks as T
from .profile_scan import GROUPS

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def host_syncs(fn) -> dict:
    """{"file:line": count} of the calls in ``fn()`` that make the host
    wait for the card (``torch.cuda.set_sync_debug_mode``'s warnings, by
    the line of the repository that made the call; "other" elsewhere)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines = []
    for w in seen:
        if "synchroniz" not in str(w.message):
            continue
        path = os.path.relpath(w.filename, REPO)
        lines.append("other" if path.startswith("..")
                     else f"{path}:{w.lineno}")
    return dict(collections.Counter(lines))


def tta_scan(model, info, views_per_call: int):
    """fn(batch) -> (mean logits, histogram delta) of one scan's 12-view
    TTA: per view (1) or at ``views_per_call`` views a call."""
    if views_per_call == 1:
        fwd = T.make_tta_eval(model)
        post = T.make_eval_post(info.n_out, info.metric_ignore)
        dev = next(model.parameters()).device
        views = [(torch.from_numpy(f).to(dev), torch.tensor(s, device=dev))
                 for f in T.TTA_FLIPS for s in T.TTA_SCALES]

        def run(b):
            outs = [fwd(b.cloud, f, s) for f, s in views]
            return post([o[0] for o in outs], b.labels, outs[0][1])
        return run
    chunked = T.make_batched_tta_eval(model, views_per_call,
                                      n_cls=info.n_out,
                                      metric_ignore=info.metric_ignore)

    def run(b):
        mean, _, _, hist = chunked(b.cloud, b.labels)
        return mean, hist
    return run


def busy_by_group(fn):
    """(device busy ms of ``fn()`` by kernel group, its wall ms under the
    profiler)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            g = next((g for g, key in GROUPS if key in e.key), "other")
            groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    return groups, wall


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/nuscenes.yaml")
    ap.add_argument("--scans", type=int, default=3)
    ap.add_argument("--views", type=int, nargs="+", default=[1, 2, 6])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tta_walls: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    cfg = load_config(args.config)
    cfg.update(device="cuda", n_val=args.scans + 1,
               outdir=os.path.join(REPO, "build", "tta_walls"))
    info, val_ds, model = M.build(cfg)
    staged = D.to_device_batch(next(D.batch_iterator(val_ds, 1)), info.task,
                               "cuda")
    for v in args.views:
        res = T.evaluate_segmentation(model, val_ds, info,
                                      batched_tta=v > 1,
                                      tta_views_per_call=v,
                                      log=lambda *a: None)
        run = tta_scan(model, info, v)
        run(staged)   # its first call stages the chunks' view parameters
        waits = host_syncs(lambda: run(staged))
        groups, wall = busy_by_group(lambda: run(staged))
        busy = sum(groups.values())
        print(json.dumps({
            "card": card, "config": args.config, "n_pad": val_ds.n_pad,
            "views_per_call": v, "scans": args.scans,
            "ms_a_view": res["scan_wall_s"] * 1e3 / T.N_VIEWS,
            "scan_tta_ms": res["scan_wall_s"] * 1e3,
            "points_per_sec": res["points_per_sec"],
            "peak_gb": res["peak_device_memory_gb"], "host_waits": waits,
            "busy_ms": busy, "by_group_ms": groups, "profiled_wall_ms": wall,
            "idle_share_profiled": 1 - busy / wall}), flush=True)


if __name__ == "__main__":
    main()
