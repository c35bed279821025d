"""One-command calibration of every static budget from a directory of scans
(counterpart of ``tools/calibrate.py``).

Every static budget of the representation (sampled rows, the sa-geo curve
window, grid cells, the fp split, the conv gap layout's curve budget, the
padded row ``n_pad``) was sized on synthetic sweeps.  This replays the
telemetry over a split that ``main.load_datasets`` reads from the config's
``data_path`` (or ``--data``; the synthetic stand-in where it is missing),
prints each budget's record and the config deltas where one truncates::

    python -m curvecloudnet_tpu_torch.tools.calibrate \\
        --config configs/nuscenes.yaml --data /path/to/nuscenes --scans 50 \\
        [--split val] [--device cpu] [--key=value ...]

The model takes ``main``'s weights (``--weights``, ``outdir``'s latest, or
random from ``seed``) and runs eval forwards at B=1 on the card (``cuda``
unless ``--device cpu``) under ``ops/telemetry.capture()``.  Further
``--key=value`` flags override the config as ``main``'s do.

Exit code 0: every budget holds; 1: some budget truncates (the printed
deltas say what to change).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def collect(model, dataset, scans: int, task: str) -> dict:
    """{channel: [value a scan]} over the first ``scans`` scans of
    ``dataset``, and ``n_pad_dropped`` (points past the padded row)."""
    from ..data import datasets as D
    from ..ops import telemetry
    from ..run.tasks import _forward

    device = next(model.parameters()).device
    totals: dict = {}
    with torch.inference_mode():
        for i, batch in enumerate(D.batch_iterator(dataset, 1,
                                                   drop_last=False)):
            if i >= scans:
                break
            totals.setdefault("n_pad_dropped", []).append(
                float(np.sum(batch.pop("n_pad_dropped"))))
            b = D.to_device_batch(batch, task, device)
            with telemetry.capture() as cap:
                _forward(model, b.cloud, b.categories, None, None)
                stats = cap.current()
            for k, v in stats.items():
                totals.setdefault(k, []).append(float(v))
    return totals


def report(totals: dict, spec, log=print) -> list:
    """Print each budget's record and the deltas -> the failures."""

    def agg(match):
        vals = [v for k, vs in totals.items() if match(k) for v in vs]
        return (max(vals), float(np.mean(vals))) if vals else (None, None)

    failures, deltas = [], []
    mx, mean = agg(lambda k: k.startswith("budget_overflow_frac"))
    if mx is not None:
        log(f"budget_overflow_frac   max={mx:.4f} mean={mean:.4f}")
        if mx > 0:
            failures.append("downsample budget overflow")
            deltas.append("raise the affected step's budget_ratio "
                          f"(max overflow fraction {mx:.3f})")
    mx, mean = agg(lambda k: k.startswith("budget_occupancy"))
    if mx is not None:
        log(f"budget_occupancy       max={mx:.4f} mean={mean:.4f}")
        if mx > 0.97:
            deltas.append(f"budget_occupancy peaks at {mx:.3f}: raise "
                          "budget_ratio ~10% for margin")

    mx, _ = agg(lambda k: k.startswith("curve_window_wanted_max"))
    tmx, _ = agg(lambda k: k.startswith("curve_window_truncated_frac"))
    if mx is not None:
        cw = [s.curve_window for s in spec.steps if s.name == "sa-geo"]
        log(f"curve_window wanted_max={mx:.0f} configured="
            f"{cw[-1] if cw else None} truncated_frac max={tmx:.2e}")
        if tmx and tmx > 0:
            failures.append("curve_window truncation")
            deltas.append(f"set sa-geo curve_window >= {int(mx * 4 / 3)} "
                          f"(wanted_max {mx:.0f} + 33% margin)")

    mx, mean = agg(lambda k: k.startswith("grid_cap_drop"))
    if mx is not None:
        log(f"grid_cap_drop          max={mx:.0f} mean={mean:.1f}")
        if mx > 0:
            failures.append("grid cap drops past overflow planes")
            deltas.append("raise the grid table's per-cell cap for the "
                          "affected row (the channel's n/r/s suffix; "
                          "ops/neighbors.grid_cap)")

    mx, _ = agg(lambda k: k.startswith("fp_split_overflow"))
    if mx is not None:
        log(f"fp_split_overflow      max={mx:.0f}")
        if mx > 0:
            deltas.append("the fp dropped-query budget overflows (the "
                          "full sweep takes over: speed only); raise "
                          "ops/interpolate.SPLIT_KEEP_FRAC's margin")

    mx, _ = agg(lambda k: k.endswith("/curve_budget_overflow")
                or "/curve_budget_overflow." in k)
    if mx is not None:
        log(f"curve_budget_overflow  max={mx:.0f}")
        if mx > 0:
            failures.append("conv1d curve_budget overflow")
            deltas.append("raise curve_budget for the conv1d steps")

    mx, mean = agg(lambda k: k == "n_pad_dropped")
    if mx is not None:
        log(f"n_pad_dropped          max={mx:.0f} mean={mean:.1f}")
        if mx > 0:
            failures.append("points past n_pad")
            deltas.append(f"raise n_pad (a scan lost {mx:.0f} points)")

    log("")
    if deltas:
        log("suggested deltas:")
        for d in deltas:
            log(" -", d)
    return failures


def main(argv=None) -> int:
    from ..config import parse_args
    from ..main import _setup

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/nuscenes.yaml")
    ap.add_argument("--data", default=None,
                    help="dataset root (defaults to the config's data_path)")
    ap.add_argument("--scans", type=int, default=16)
    ap.add_argument("--split", default="val", choices=("train", "val"))
    args, rest = ap.parse_known_args(argv)
    cfg = parse_args(["--config", args.config] + rest)
    if args.data:
        cfg["data_path"] = args.data
    info, train_ds, val_ds, model, _, _ = _setup(cfg)
    dataset = {"train": train_ds, "val": val_ds}[args.split]
    n_scans = min(args.scans, len(dataset))
    totals = collect(model.eval(), dataset, n_scans, info.task)
    print(f"== calibration over {n_scans} {args.split} scans "
          f"({cfg.get('dataset_source')}, n_pad={dataset.n_pad}, "
          f"{next(model.parameters()).device}) ==")
    failures = report(totals, model.spec)
    if failures:
        print("FAIL:", "; ".join(failures))
        return 1
    print("PASS: every static budget holds on this data")
    return 0


if __name__ == "__main__":
    sys.exit(main())
