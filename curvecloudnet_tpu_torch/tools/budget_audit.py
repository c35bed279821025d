"""Audit every static-budget stage of a config on synthetic sweeps
(counterpart of ``tools/budget_audit.py``): eval forwards under
``ops/telemetry.capture()``, each channel's max and mean over the scans::

    AUDIT_CONFIG=configs/nuscenes.yaml AUDIT_POINTS=36864 AUDIT_SCANS=4 \\
        python -m curvecloudnet_tpu_torch.tools.budget_audit [--device cpu]

``AUDIT_POINTS`` defaults to the config's ``n_pad``; the inputs are
``predict.synthetic_inputs`` of the config's task (a sweep of its sensor
or a batch of object scans, seeds 0, 1, ...), the weights random (seed
0), on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def audit(config: str, n_pad: int, scans: int, device) -> dict:
    """{channel: [value a scan]} of ``scans`` synthetic inputs of the
    config's task (``predict.synthetic_inputs`` seeds 0, 1, ...: a sweep
    of its sensor, or a batch of object scans)."""
    from ..ops import telemetry
    from ..predict import build_model, predict, synthetic_inputs

    model = build_model(config, n_pad, device)
    totals: dict = {}
    for seed in range(scans):
        inputs = synthetic_inputs(config, seed, n_pad, device)
        with telemetry.capture() as cap:
            predict(model, *inputs)
            stats = cap.current()
        for k, v in stats.items():
            totals.setdefault(k, []).append(float(v))
    return totals


def main(argv=None) -> None:
    from ..config import load_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = os.environ.get("AUDIT_CONFIG", "configs/nuscenes.yaml")
    n_pad = int(os.environ.get("AUDIT_POINTS",
                               load_config(config).get("n_pad", 36864)))
    totals = audit(config, n_pad, int(os.environ.get("AUDIT_SCANS", 4)),
                   torch.device(args.device))
    print(f"== telemetry over {len(next(iter(totals.values())))} scans "
          f"(n_pad={n_pad}) ==")
    for k in sorted(totals):
        vals = totals[k]
        flag = ("  <-- OVERFLOW" if "overflow" in k and max(vals) > 0
                else "")
        print(f"{k:60s} max={max(vals):10.4f} mean={np.mean(vals):10.4f}"
              f"{flag}")


if __name__ == "__main__":
    main()
