"""Train and eval steps (counterpart of
``curvecloudnet_tpu/train/trainer.py``): Adam with a learning rate
stepped once per epoch (exponential, or cosine warm restarts), the
reference's BatchNorm momentum decay, and one step = one forward in train
mode, the task's loss (segmentation or classification), its backward and
the optimizer update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import parallel
from ..models.cloud import Cloud
from ..run import losses as losses_lib


@dataclasses.dataclass
class Batch:
    """A padded cloud and its labels."""
    cloud: Cloud
    labels: torch.Tensor                        # (B, N) seg or (B,) class
    label_valid: Optional[torch.Tensor] = None  # (B, N) or None -> valid
    categories: Optional[torch.Tensor] = None   # (B,) object category


@dataclasses.dataclass(frozen=True)
class LossConfig:
    task: str = "segmentation"              # or "classification"
    ignore_index: Optional[int] = 0
    use_lovasz: bool = False
    lovasz_weight: float = 1.0
    mean_over_all: bool = False
    class_weights: Optional[tuple] = None   # NLL weight of each class


def make_schedule(scheduler_cfg: dict, base_lr: float, steps_per_epoch: int):
    """step count -> learning rate, constant within an epoch.

    ``exp``: lr * gamma^epoch.  ``cosine``: warm restarts with period
    doubling, eta_min added, each cycle a cosine decay of base_lr - eta_min
    (optax's ``cosine_decay_schedule`` joined at the restarts)."""
    scheduler_cfg = scheduler_cfg or {}
    name = scheduler_cfg.get("name", "exp")
    spe = max(1, steps_per_epoch)
    if name == "exp":
        gamma = scheduler_cfg.get("lr_gamma", 0.97)
        return lambda count: base_lr * gamma ** (count // spe)
    if name == "cosine":
        t0 = scheduler_cfg.get("T_0", 10)
        mult = scheduler_cfg.get("T_mult", 2)
        eta_min = scheduler_cfg.get("eta_min", base_lr * 0.01)

        def sched(count):
            t = (count // spe) * spe
            start, period = 0, t0
            for _ in range(7):
                if t < start + period * spe:
                    break
                start += period * spe
                period *= mult
            frac = min(t - start, period * spe) / (period * spe)
            return ((base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * frac))
                    + eta_min)
        return sched
    raise ValueError(f"unknown scheduler {name!r}")


def bn_momentum_for_epoch(epoch: int, decay: float = 0.97,
                          initial: float = 0.1, floor: float = 0.01) -> float:
    """Reference BN momentum decay (main.py:144-146)."""
    return max(floor, initial * decay ** epoch)


def create_optimizer(model: torch.nn.Module, lr: float = 0.0,
                     weight_decay: float = 0.0):
    """``optax.adam`` (betas 0.9/0.999, eps 1e-8 outside the root) as
    ``torch.optim.Adam``; ``optax.adamw`` as AdamW when weight_decay > 0.
    The learning rate is set per step by :func:`train_step`."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if weight_decay > 0:
        return torch.optim.AdamW(model.parameters(), weight_decay=weight_decay,
                                 **kw)
    return torch.optim.Adam(model.parameters(), **kw)


def compute_loss(logits, out_valid, batch: Batch, cfg: LossConfig):
    if cfg.task == "classification":
        return losses_lib.classification_loss(logits[:, 0, :], batch.labels)
    lv = batch.label_valid if batch.label_valid is not None else out_valid
    class_weights = (None if cfg.class_weights is None else torch.tensor(
        cfg.class_weights, dtype=torch.float32, device=logits.device))
    return losses_lib.seg_loss(
        logits, batch.labels, lv & out_valid, ignore_index=cfg.ignore_index,
        use_lovasz=cfg.use_lovasz, lovasz_weight=cfg.lovasz_weight,
        class_weights=class_weights, mean_over_all=cfg.mean_over_all)


def _categories(model, batch: Batch):
    """The batch's categories where the model has the category head."""
    return batch.categories if model.spec.with_seg_category else None


def train_step(model, optimizer, lr: float, batch: Batch, generator=None,
               bn_momentum: float = 0.1, loss_cfg: LossConfig = LossConfig()):
    """One optimizer step; returns {"loss": detached scalar} and, for
    classification, {"acc": the batch's accuracy}, on the device.

    In a data-parallel step (``parallel``: a process group of R processes,
    ``batch`` this process's B / R samples of the global batch) it is the
    step on the global batch: the statistics and loss terms are summed
    over the processes as the forward forms them, the gradients after the
    backward (one all-reduce a dtype), and the loss and accuracy returned
    are the global batch's on every process."""
    optimizer.zero_grad(set_to_none=True)
    logits, out_valid = model(batch.cloud, _categories(model, batch),
                              train=True, bn_momentum=bn_momentum,
                              generator=generator)
    loss = compute_loss(logits, out_valid, batch, loss_cfg)
    loss.backward()
    parallel.sum_gradients(model.parameters())
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    metrics = {"loss": loss.detach()}
    if loss_cfg.task == "classification":
        pred = logits[:, 0, :].detach().argmax(dim=-1)
        hit = (pred == batch.labels.long()).float()
        if parallel.world() > 1:
            right, n = parallel.reduce_sum(torch.stack(
                [hit.sum(), hit.new_tensor(float(hit.numel()))])).unbind(0)
            metrics["acc"] = right / n
        else:
            metrics["acc"] = hit.mean()
    return metrics


@torch.no_grad()
def eval_step(model, batch: Batch, loss_cfg: LossConfig = LossConfig()):
    """(logits, out_valid, loss) of the eval forward of ``batch`` (this
    process's alone: ``parallel.sharded_eval_step`` takes a global
    batch's shard)."""
    with parallel.local():
        logits, out_valid = model(batch.cloud, _categories(model, batch))
        return logits, out_valid, compute_loss(logits, out_valid, batch,
                                               loss_cfg)
