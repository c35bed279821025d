"""The loss part of the JAX package's task registry for the ported lidar
datasets (``curvecloudnet_tpu/run/tasks.py`` ``TASKS``, its class weights
from ``run/globals.py``), and how the JAX train entry picks a config's
loss (``curvecloudnet_tpu/main.py``: ``use_lovasz_loss`` overrides the
task's Lovász switch; the class weights apply when ``use_ce_weights`` is
set).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..train.trainer import LossConfig

# SemanticKITTI's 19 labelled classes (1..19): inverse-frequency weights,
# normalized to sum 1; class 0 ('unlabeled') is the ignore index
_KITTI_W = np.array([
    3.1557, 8.7029, 7.8281, 6.1354, 6.3161, 7.9937, 8.9704, 10.1922, 1.6155,
    4.2187, 1.9385, 5.5455, 2.0198, 2.6261, 1.3212, 5.1102, 2.5492, 5.8585,
    7.3929,
])
KITTI_CLASS_WEIGHTS = tuple(float(w) for w in
                            np.concatenate([[0.0], _KITTI_W / _KITTI_W.sum()]))

# dataset -> (loss without class weights, the task's class weights)
TASK_LOSSES = {
    "nuscenes": (LossConfig(ignore_index=0, use_lovasz=True,
                            lovasz_weight=1.0), None),
    "kitti": (LossConfig(ignore_index=0, use_lovasz=True, lovasz_weight=2.0,
                         mean_over_all=True), KITTI_CLASS_WEIGHTS),
}


def loss_for(cfg: dict) -> LossConfig:
    """The loss a config trains with, as the JAX train entry picks it."""
    loss, weights = TASK_LOSSES[cfg.get("dataset_source", "nuscenes")]
    changes = {}
    if "use_lovasz_loss" in cfg:
        changes["use_lovasz"] = bool(cfg["use_lovasz_loss"])
    if cfg.get("use_ce_weights") and weights is not None:
        changes["class_weights"] = weights
    return dataclasses.replace(loss, **changes)
