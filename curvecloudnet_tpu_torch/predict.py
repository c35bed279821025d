"""Serving entry point: the lidarseg eval forward of a config's model.

Counterpart of the JAX package's eval forward in ``bench.py`` and
``__graft_entry__.entry()``.  Sampling runs at the deterministic ``key=None``
operating point (FPS from index 0, curve sampling phase 0, no voxel
jitter).  Run, e.g. on the GPU::

    python -m curvecloudnet_tpu_torch.predict --config configs/nuscenes.yaml \\
        --scans 3 --device cuda
    python -m curvecloudnet_tpu_torch.predict --config configs/kitti.yaml
    python -m curvecloudnet_tpu_torch.predict --edge-kernel fused

which serves synthetic scans (seeds 0, 1, ...) of the config's dataset's
sensor at the config's ``n_pad`` with B=1 and prints one JSON line per
scan.  ``--edge-kernel`` picks the sgcnn steps' eval route: ``group`` (K4 +
K2, the default) or ``fused`` (K9 on the steps whose widths admit it).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .config import load_config
from .data import lidar_batch
from .models import CurveCloudNet, cloud_from_arrays, parse_model_config
from .models.modules import EDGE_ROUTES

# output classes of the ported datasets (curvecloudnet_tpu/run/tasks.py)
N_OUT = {"nuscenes": 17, "kitti": 20}
# beams (curves) of each dataset's lidar: nuScenes' sensor has 32, KITTI's
# 64 (the JAX package's grid recall tests draw 64 for KITTI rows; its
# bench.py draws 32 at every size)
N_BEAMS = {"nuscenes": 32, "kitti": 64}
FEAT_CHANNELS = 1   # per-point reflectance of the lidar loaders
IN_DIM = 4          # the spec's declared input width: reflectance + xyz


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


def dataset_of(config_path: str) -> str:
    return load_config(config_path).get("dataset_source", "nuscenes")


def build_model(config_path: str, n_pad: int, device, generator=None,
                edge_kernel: str = "group"):
    """The config's model with random weights from ``generator`` (seed 0
    when None), in eval mode on ``device``, its sgcnn steps on the eval
    route ``edge_kernel`` (the weights do not depend on it)."""
    cfg = load_config(config_path)
    n_out = N_OUT[cfg.get("dataset_source", "nuscenes")]
    spec = parse_model_config(cfg["model"], in_dim=IN_DIM, n_out=n_out)
    model = CurveCloudNet(spec, n_points=n_pad, feat_channels=FEAT_CHANNELS,
                          edge_kernel=edge_kernel)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(device).eval()


@torch.inference_mode()
def predict(model, pos, feat, curve_id, valid):
    """One padded batch -> (logits (B, N, n_out), valid (B, N), argmax)."""
    cloud = cloud_from_arrays(pos, curve_id, valid, feat)
    logits, out_valid = model(cloud)
    return logits, out_valid, logits.argmax(dim=-1)


def synthetic_scan(seed: int, n_pad: int, device, n_beams: int = 32):
    """One synthetic lidar sweep (B=1) as tensors on ``device``."""
    pos, feat, curve_id, valid, _ = lidar_batch(
        np.random.default_rng(seed), 1, n_pad, n_beams=n_beams)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (pos, feat, curve_id, valid))


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
    n_pad = int(load_config(args.config)["n_pad"])
    n_beams = N_BEAMS[dataset_of(args.config)]
    model = build_model(args.config, n_pad, device,
                        edge_kernel=args.edge_kernel)
    for scan in range(args.scans):
        inputs = synthetic_scan(scan, n_pad, device, n_beams)
        t0 = time.perf_counter()
        logits, valid, pred = predict(model, *inputs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        live = logits[valid]
        print(json.dumps({
            "scan": scan, "n_pad": n_pad, "n_valid": int(valid.sum()),
            "ms": ms, "finite": bool(torch.isfinite(live).all()),
            "classes_predicted": int(torch.unique(pred[valid]).numel()),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}))


if __name__ == "__main__":
    main()
