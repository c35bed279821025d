"""Serving entry point: the eval forward of a config's model.

Counterpart of the JAX package's eval forward in ``bench.py`` and
``__graft_entry__.entry()``.  Sampling runs at the deterministic ``key=None``
operating point (FPS from index 0, curve sampling phase 0, no voxel
jitter).  Run, e.g. on the GPU::

    python -m curvecloudnet_tpu_torch.predict --config configs/nuscenes.yaml \\
        --scans 3 --device cuda
    python -m curvecloudnet_tpu_torch.predict --config configs/kitti.yaml
    python -m curvecloudnet_tpu_torch.predict --config configs/audi.yaml
    python -m curvecloudnet_tpu_torch.predict --config configs/shapenet-seg.yaml
    python -m curvecloudnet_tpu_torch.predict --edge-kernel fused

and ``--device cpu`` for the CPU.  A lidar config (nuScenes, KITTI, A2D2)
serves synthetic sweeps (seeds 0, 1, ...) of its dataset's sensor at the
config's ``n_pad`` with B=1; an object config (ShapeNet part segmentation
and classification, Kortx) serves batches of synthetic object scans at its
``n_pad`` (2048, the JAX entry's default, where it sets none) and its
``batch_size``, each sample's category passed to a model with the category
head.  One JSON line a batch; a classification model's line holds each
sample's logits.  ``--edge-kernel`` picks the sgcnn steps' eval route:
``group`` (K4 + K2, the default) or ``fused`` (K9 on the steps whose widths
and aggregation admit it).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .config import load_config
from .data import lidar_batch, object_batch
from .models import CurveCloudNet, cloud_from_arrays, parse_model_config
from .models.modules import EDGE_ROUTES
from .run.tasks import TASKS, task_for

# output classes of each task
N_OUT = {name: info.n_out for name, info in TASKS.items()}
# beams (curves) of each lidar dataset's sensor: nuScenes' has 32, KITTI's
# 64 (the JAX package's grid recall tests draw 64 for KITTI rows; its
# bench.py draws 32 at every size), A2D2's car five lidars of 16 beams
N_BEAMS = {"nuscenes": 32, "kitti": 64, "audi": 80}
# the object tasks: position-only scans (the spec's input width 3, the
# JAX object datasets' in_dim), served in batches
OBJECT_TASKS = ("shapenet-seg", "kortx", "shapenet-class")
FEAT_CHANNELS = 1   # per-point reflectance of the lidar loaders
IN_DIM = 4          # a lidar spec's declared input width: reflectance + xyz
OBJECT_IN_DIM = 3
DEFAULT_N_PAD = 2048   # the JAX entry's n_pad where a config sets none


def task_of(cfg: dict) -> str:
    """The task a config serves (``run/tasks.task_for`` on its
    ``dataset_source`` and ``task``)."""
    return task_for(cfg.get("dataset_source", "nuscenes"),
                    cfg.get("task", "segmentation")).name


def dataset_of(config_path: str) -> str:
    return task_of(load_config(config_path))


def n_pad_of(config_path: str) -> int:
    return int(load_config(config_path).get("n_pad", DEFAULT_N_PAD))


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Random weights from a seeded generator: Linear/taps N(0, 1/fan_in);
    BatchNorm scale, shift and running statistics drawn near identity so
    that the BN folds are exercised."""
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and t.dim() >= 2:
                fan_in = math.prod(t.shape[1:])
                t.copy_(torch.randn(t.shape, generator=generator)
                        / math.sqrt(fan_in))
            elif leaf in ("weight", "running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=generator))
            elif leaf in ("bias", "running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=generator))


def build_model(config_path: str, n_pad: int, device, generator=None,
                edge_kernel: str = "group"):
    """The config's model with random weights from ``generator`` (seed 0
    when None), in eval mode on ``device``, its sgcnn steps on the eval
    route ``edge_kernel`` (the weights do not depend on it)."""
    cfg = load_config(config_path)
    task = task_of(cfg)
    objects = task in OBJECT_TASKS
    spec = parse_model_config(cfg["model"],
                              in_dim=OBJECT_IN_DIM if objects else IN_DIM,
                              n_out=N_OUT[task])
    model = CurveCloudNet(spec, n_points=n_pad,
                          feat_channels=None if objects else FEAT_CHANNELS,
                          edge_kernel=edge_kernel)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(device).eval()


@torch.inference_mode()
def predict(model, pos, feat, curve_id, valid, categories=None):
    """One padded batch -> (logits (B, N, n_out), valid (B, N), argmax); N
    is 1 for a classification model.  ``feat`` is None for position-only
    scans; ``categories`` (B,) for a model with the category head."""
    cloud = cloud_from_arrays(pos, curve_id, valid, feat)
    logits, out_valid = model(cloud, categories)
    return logits, out_valid, logits.argmax(dim=-1)


def synthetic_scan(seed: int, n_pad: int, device, n_beams: int = 32):
    """One synthetic lidar sweep (B=1) as tensors on ``device``."""
    pos, feat, curve_id, valid, _ = lidar_batch(
        np.random.default_rng(seed), 1, n_pad, n_beams=n_beams)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (pos, feat, curve_id, valid))


def synthetic_objects(seed: int, n_pad: int, batch: int, device,
                      categories: bool = True):
    """A batch of synthetic object scans -> (pos, None, curve_id, valid,
    categories or None) on ``device``, the arguments of :func:`predict`."""
    pos, curve_id, valid, _, cats = object_batch(
        np.random.default_rng(seed), batch, n_pad)
    pos, curve_id, valid, cats = (torch.from_numpy(a).to(device)
                                  for a in (pos, curve_id, valid, cats))
    return pos, None, curve_id, valid, cats if categories else None


def synthetic_inputs(config_path: str, seed: int, n_pad: int, device):
    """The arguments of :func:`predict` for one synthetic batch of a
    config's task: a lidar sweep of its sensor (B=1) or a batch of object
    scans of the config's ``batch_size``."""
    cfg = load_config(config_path)
    task = task_of(cfg)
    if task in OBJECT_TASKS:
        with_cat = bool(cfg["model"].get("out_mlp", {}).get(
            "with_seg_category", False))
        return synthetic_objects(seed, n_pad, int(cfg.get("batch_size", 1)),
                                 device, categories=with_cat)
    return synthetic_scan(seed, n_pad, device, N_BEAMS[task])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/nuscenes.yaml")
    ap.add_argument("--scans", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--edge-kernel", default="group", choices=EDGE_ROUTES)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    n_pad = n_pad_of(args.config)
    model = build_model(args.config, n_pad, device,
                        edge_kernel=args.edge_kernel)
    classify = dataset_of(args.config) == "shapenet-class"
    for scan in range(args.scans):
        inputs = synthetic_inputs(args.config, scan, n_pad, device)
        t0 = time.perf_counter()
        logits, valid, pred = predict(model, *inputs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        live = logits[valid]
        line = {
            "scan": scan, "n_pad": n_pad, "batch": logits.shape[0],
            "n_valid": int(inputs[3].sum()), "ms": ms,
            "finite": bool(torch.isfinite(live).all()),
            "classes_predicted": int(torch.unique(pred[valid]).numel()),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}
        if classify:
            line["logits"] = logits[:, 0].tolist()
        print(json.dumps(line))


if __name__ == "__main__":
    main()
