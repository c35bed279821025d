"""Train entry point: a few optimizer steps of a config's model on the
port's labelled synthetic sweep.  Run, e.g. on the GPU::

    python -m curvecloudnet_tpu_torch.train --config configs/nuscenes.yaml \\
        --steps 5 --device cuda

It builds the model at the config's ``n_pad`` with B=1 and random weights
from ``--seed`` (``predict.init_weights``), trains on synthetic sweep
``--seed`` of the config's dataset's sensor with its labels (the dataset's
loss as the JAX train entry picks it, ``run/tasks.loss_for``), learning
rate from the config on its schedule, BatchNorm momentum 0.1, and prints
one JSON line per step.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import load_config
from ..data import lidar_batch
from ..models import cloud_from_arrays
from ..predict import N_BEAMS, N_OUT, build_model
from ..run.tasks import loss_for
from .trainer import Batch, create_optimizer, make_schedule, train_step


def synthetic_batch(seed: int, n_pad: int, device, batch: int = 1,
                    dataset: str = "nuscenes") -> Batch:
    """Labelled synthetic sweeps (seed ``seed``) of ``dataset``'s sensor
    (its beams and class count) as a Batch on ``device``."""
    pos, feat, cid, valid, labels = (
        torch.from_numpy(a).to(device)
        for a in lidar_batch(np.random.default_rng(seed), batch, n_pad,
                             n_beams=N_BEAMS[dataset],
                             n_classes=N_OUT[dataset]))
    return Batch(cloud=cloud_from_arrays(pos, cid, valid, feat),
                 labels=labels)


def setup(config_path: str, device, seed: int = 0, n_pad: int | None = None):
    """(model, optimizer, schedule, loss config, batch, generator)."""
    cfg = load_config(config_path)
    n_pad = int(cfg["n_pad"]) if n_pad is None else n_pad
    model = build_model(config_path, n_pad, device,
                        torch.Generator().manual_seed(seed))
    opt = create_optimizer(model, weight_decay=float(
        cfg.get("weight_decay", 0.0)))
    sched = make_schedule(cfg.get("scheduler"), float(cfg["lr"]), 1)
    dataset = cfg.get("dataset_source", "nuscenes")
    gen = torch.Generator(device=device).manual_seed(seed)
    return (model, opt, sched, loss_for(cfg),
            synthetic_batch(seed, n_pad, device, dataset=dataset), gen)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/nuscenes.yaml")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    model, opt, sched, loss_cfg, batch, gen = setup(args.config, device,
                                                    args.seed)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    for step in range(args.steps):
        t0 = time.perf_counter()
        loss = train_step(model, opt, sched(0), batch, gen, 0.1,
                          loss_cfg)["loss"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        print(json.dumps({"step": step, "loss": float(loss), "ms": ms,
                          "device": name}), flush=True)


if __name__ == "__main__":
    main()
