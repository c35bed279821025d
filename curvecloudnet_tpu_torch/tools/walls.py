"""End-to-end walls on the GPU: nuScenes scans, KITTI scans, train steps.

Builds the nuScenes flagship (``configs/nuscenes.yaml``, n_pad 36864) and
the KITTI model (``configs/kitti.yaml``, n_pad 131072) at B=1 on their
synthetic sweeps (seeds 0-2, in turn), and the nuScenes train step
(sweep 0, NLL + Lovász, Adam at 5e-4); after one warm-up each, times
every scan and step on the host clock up to ``torch.cuda.synchronize()``.
Run from the repository root, in turns with another tree's copy to
compare two commits::

    python -m curvecloudnet_tpu_torch.tools.walls [--scans 12] [--kitti 6] [--steps 6]

Prints one JSON line: the card, and the list of milliseconds of each.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import predict as P
from ..train import LossConfig, train_step
from ..train.__main__ import synthetic_batch
from ..train.trainer import create_optimizer


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def scans(config: str, n_pad: int, count: int, dev) -> list:
    model = P.build_model(config, n_pad, dev)
    beams = P.N_BEAMS[P.dataset_of(config)]
    inputs = [P.synthetic_scan(s, n_pad, dev, beams) for s in range(3)]
    P.predict(model, *inputs[0])
    return [wall_ms(lambda i=i: P.predict(model, *inputs[i % 3]))
            for i in range(count)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--kitti", type=int, default=6)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("walls: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0),
           "nuscenes_ms": scans("configs/nuscenes.yaml", 36864, args.scans,
                                dev),
           "kitti_ms": scans("configs/kitti.yaml", 131072, args.kitti, dev)}
    model = P.build_model("configs/nuscenes.yaml", 36864, dev).train()
    opt = create_optimizer(model)
    batch = synthetic_batch(0, 36864, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    loss = LossConfig(ignore_index=0, use_lovasz=True)
    train_step(model, opt, 5e-4, batch, gen, 0.1, loss)
    out["train_step_ms"] = [
        wall_ms(lambda: train_step(model, opt, 5e-4, batch, gen, 0.1, loss))
        for _ in range(args.steps)]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
