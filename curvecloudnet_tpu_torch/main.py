"""The config-driven eval and test entry point (counterpart of
``curvecloudnet_tpu/main.py``).

Usage, as the reference's (``src/main.py``)::

    python -m curvecloudnet_tpu_torch.main --config configs/nuscenes.yaml \\
        --only_val=true [--n_val=2] [--device=cpu] [--key=value ...]

``--only_val`` scores the val split (mIoU under 12-view TTA for the lidar
datasets, part mIoU or accuracy for the objects); ``--only_test`` also
writes the test-split submission files under ``outdir``.  The model is
built at the dataset's ``n_pad`` on ``device`` (default ``cuda``; there is
no fallback to the CPU), with random weights from ``seed``, the
reference ``.pth`` at ``weights``, a native checkpoint at ``weights``, or
the ``latest`` checkpoint of ``outdir``.  Where ``data_path`` does not
exist the datasets are the JAX entry's synthetic stand-ins.

Not ported yet, and raising ``NotImplementedError``: the epoch loop
(training; ``python -m curvecloudnet_tpu_torch.train`` is the train
entry), ``only_viz``, more than one process, and reading real datasets.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from . import checkpoint as ckpt
from .config import DEFAULT_DEVICE, parse_args
from .data import datasets as D
from .logging_utils import MetricLogger
from .models import CurveCloudNet, parse_model_config
from .run import tasks as T

LIDAR_SOURCES = ("nuscenes", "kitti", "audi")
OBJECT_SOURCES = ("shapenet-seg", "shapenet", "kortx")


def load_datasets(cfg):
    """(train, val) datasets of a config (the reference's
    load_utils.load_dataset:73-126): the synthetic stand-ins where
    ``data_path`` does not exist."""
    src = cfg["dataset_source"]
    if src == "summer-robotics":  # the reference's Kortx test split
        src = "kortx"
    task = cfg.get("task", "segmentation")
    data_path = cfg.get("data_path", "")
    n_pad = int(cfg.get("n_pad", 2048 if "shapenet" in src or "kortx" in src
                         or "object" in src else 32768))
    have_data = bool(data_path) and os.path.exists(data_path)
    if have_data and src in LIDAR_SOURCES + OBJECT_SOURCES:
        raise NotImplementedError(
            f"reading {src} from {data_path!r} is not ported (ROADMAP.md "
            "queue 1, item 5: the data layer)")

    if src.startswith("synthetic-lidar") or src in LIDAR_SOURCES:
        if not src.startswith("synthetic"):
            print(f"[data] {data_path!r} missing -> synthetic lidar stand-in")
        n_cls = T.task_for(src, task).n_out if src in T.TASKS else 17
        train = D.SyntheticLidarSeg(n_samples=cfg.get("n_train", 32),
                                    n_pad=n_pad, n_classes=n_cls, seed=1)
        val = D.SyntheticLidarSeg(n_samples=cfg.get("n_val", 8),
                                  n_pad=n_pad, n_classes=n_cls, seed=2)
        return train, val

    if src.startswith("synthetic-object") or src in OBJECT_SOURCES:
        if not src.startswith("synthetic"):
            print(f"[data] {data_path!r} missing -> synthetic objects "
                  "stand-in")
        train = D.SyntheticObjects(n_samples=cfg.get("n_train", 64),
                                   n_pad=n_pad, task=task, seed=1)
        val = D.SyntheticObjects(n_samples=cfg.get("n_val", 16),
                                 n_pad=n_pad, task=task, seed=2)
        return train, val

    raise KeyError(f"unknown dataset_source {src!r}")


def run_eval(model, val_ds, info, cfg, log=print, logger=None,
             generator: torch.Generator | None = None):
    """The task's eval loop on the val set.  Lidar scenes evaluate at
    batch 1 (reference main.py:32), objects in batches of 8.  ``logger``
    is the JAX loop's media logger for the classification confusion
    figure, which is not ported, so the figure is not drawn."""
    del logger
    lidar_scene = info.task == "segmentation" and not info.part_iou
    bs = int(cfg.get("eval_batch_size", 1 if lidar_scene else 8))
    max_b = cfg.get("eval_max_batches")
    if info.task == "classification":
        return T.evaluate_classification(model, val_ds, info, batch_size=bs,
                                         max_batches=max_b, log=log,
                                         generator=generator)
    if info.part_iou:
        return T.evaluate_part_segmentation(model, val_ds, info,
                                            batch_size=bs, max_batches=max_b,
                                            log=log, generator=generator)
    return T.evaluate_segmentation(
        model, val_ds, info, batch_size=bs, max_batches=max_b,
        use_tta=cfg.get("use_tta"), log=log,
        test_mode=_flag(cfg, "only_test"), outdir=cfg.get("outdir"),
        generator=generator)


def score_of(result: dict) -> float:
    for k in ("miou", "instance_miou", "accuracy"):
        if k in result:
            return float(result[k])
    return float("nan")


def _flag(cfg: dict, key: str) -> bool:
    """A switch of the config; a flag the file lacks arrives as a string."""
    v = cfg.get(key)
    if isinstance(v, str):
        return v.lower() not in ("", "false", "0", "no")
    return bool(v)


def device_of(cfg: dict) -> torch.device:
    """The config's device; a CUDA device must be present."""
    device = torch.device(cfg.get("device") or DEFAULT_DEVICE)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass --device=cpu to run on the CPU)")
    return device


def build(cfg: dict, logger: Optional[MetricLogger] = None):
    """(task info, val dataset, model in eval mode on the config's device)
    with the weights of ``weights``, of ``outdir``'s ``latest``
    checkpoint, or random from ``seed``."""
    from .predict import init_weights

    device = device_of(cfg)
    info = T.task_for(cfg["dataset_source"], cfg.get("task", "segmentation"))
    train_ds, val_ds = load_datasets(cfg)
    spec = parse_model_config(cfg["model"], in_dim=train_ds.in_dim,
                              n_out=info.n_out)
    feat = train_ds.in_dim - 3
    model = CurveCloudNet(spec, n_points=train_ds.n_pad,
                          feat_channels=feat or None,
                          edge_kernel=cfg.get("edge_kernel", "group"))
    init_weights(model, torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model Parameters: {n_params:,}")
    if logger is not None:
        logger.log({"model_parameters": int(n_params)})

    outdir = cfg.get("outdir", "./out/run")
    weights = cfg.get("weights", "")
    if weights:
        if weights.endswith((".pth", ".pt")):
            ckpt.load_reference_state_dict(
                model, torch.load(weights, map_location="cpu",
                                  weights_only=True))
            print(f"loaded torch weights from {weights}")
        else:
            ckpt.restore_checkpoint(os.path.dirname(weights) or ".",
                                    os.path.basename(weights), model)
    elif ckpt.has_latest(outdir):
        ckpt.restore_checkpoint(outdir, "latest", model)
        latest = ckpt.read_latest_state(outdir) or {}
        if logger is not None:
            # run-spanning statistics must see the entries before a resume
            logger.reload_history()
        print(f"resumed from {outdir} at epoch "
              f"{int(latest.get('epoch', -1)) + 1}")
    return info, val_ds, model.to(device).eval()


def main(cfg: dict) -> Optional[float]:
    """The eval / test entry: the val set's score (mIoU, instance part
    mIoU or accuracy)."""
    dist = cfg.get("distributed") or {}
    if int(dist.get("num_processes") or 0) > 1:
        raise NotImplementedError("distributed.num_processes > 1: scale-out "
                                  "is not ported (ROADMAP.md queue 1, item 6)")
    if _flag(cfg, "only_viz"):
        raise NotImplementedError("only_viz: visualization/ is not ported "
                                  "(ROADMAP.md queue 1, item 7)")
    if not (_flag(cfg, "only_val") or _flag(cfg, "only_test")):
        raise NotImplementedError(
            "the epoch loop (training) of main is not ported (ROADMAP.md "
            "queue 1, item 4); train with python -m "
            "curvecloudnet_tpu_torch.train")
    outdir = cfg.get("outdir", "./out/run")
    os.makedirs(outdir, exist_ok=True)
    logger = MetricLogger(outdir, use_wandb=_flag(cfg, "use_wandb"),
                          config=cfg)
    try:
        info, val_ds, model = build(cfg, logger)
        result = run_eval(model, val_ds, info, cfg, logger=logger)
        logger.log({k: v for k, v in result.items()
                    if isinstance(v, (int, float))})
    finally:
        logger.close()
    return score_of(result)


if __name__ == "__main__":
    main(parse_args())
