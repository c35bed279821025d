"""Train entry point: a few optimizer steps of a config's model on a
labelled synthetic batch of its task.  Run, e.g. on the GPU::

    python -m curvecloudnet_tpu_torch.train --config configs/nuscenes.yaml \\
        --steps 5 --device cuda

and ``--config configs/kitti.yaml`` (``audi.yaml``, ``shapenet-seg.yaml``,
``kortx-testsplit.yaml``, ``shapenet-class.yaml``) for the other shipped
configs, ``--device cpu`` for the CPU.  It builds the model at the
config's ``n_pad`` (2048 where the config sets none) with random weights
from ``--seed`` (``predict.init_weights``).  A lidar config trains on
synthetic sweep ``--seed`` of its dataset's sensor with its labels, B=1;
an object config on a batch of ``--seed``'s synthetic object scans
(``data.object_batch``) at its ``batch_size``: part labels for part
segmentation, each scan's category for classification, the categories
to a model with the category head.  The loss is the config's task's, as
the JAX entry picks it (``run/tasks.loss_for``); learning rate from the
config on its schedule, BatchNorm momentum 0.1.  It prints one JSON line
per step (with the batch's accuracy for classification).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import load_config
from ..data import lidar_batch, object_batch
from ..models import cloud_from_arrays
from ..predict import N_BEAMS, N_OUT, OBJECT_TASKS, build_model, n_pad_of
from ..predict import task_of
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


def object_train_batch(seed: int, n_pad: int, device, batch: int,
                       task: str) -> Batch:
    """``batch`` labelled synthetic object scans (seed ``seed``) as a Batch
    on ``device``: per-point part labels, or for ``shapenet-class`` each
    scan's category; the categories ride along for the category head."""
    pos, cid, valid, parts, cats = (
        torch.from_numpy(a).to(device)
        for a in object_batch(np.random.default_rng(seed), batch, n_pad))
    return Batch(cloud=cloud_from_arrays(pos, cid, valid, None),
                 labels=cats if task == "shapenet-class" else parts,
                 categories=cats)


def train_batch(config_path: str, seed: int, n_pad: int, device) -> Batch:
    """The synthetic train batch of a config's task: a sweep of its sensor
    (B=1), or object scans at its ``batch_size``."""
    cfg = load_config(config_path)
    task = task_of(cfg)
    if task in OBJECT_TASKS:
        return object_train_batch(seed, n_pad, device,
                                  int(cfg.get("batch_size", 1)), task)
    return synthetic_batch(seed, n_pad, device, dataset=task)


def setup(config_path: str, device, seed: int = 0, n_pad: int | None = None):
    """(model, optimizer, schedule, loss config, batch, generator)."""
    cfg = load_config(config_path)
    n_pad = n_pad_of(config_path) if n_pad is None else n_pad
    model = build_model(config_path, n_pad, device,
                        torch.Generator().manual_seed(seed))
    opt = create_optimizer(model, weight_decay=float(
        cfg.get("weight_decay", 0.0)))
    sched = make_schedule(cfg.get("scheduler"), float(cfg["lr"]), 1)
    gen = torch.Generator(device=device).manual_seed(seed)
    return (model, opt, sched, loss_for(cfg),
            train_batch(config_path, seed, n_pad, device), gen)


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
        out = train_step(model, opt, sched(0), batch, gen, 0.1, loss_cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        print(json.dumps({"step": step, "ms": ms, "device": name,
                          **{k: float(v) for k, v in out.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
