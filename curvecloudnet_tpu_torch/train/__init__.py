"""Training steps of the port (counterpart of ``curvecloudnet_tpu/train``)."""

from .trainer import (Batch, LossConfig, bn_momentum_for_epoch,
                      create_optimizer, eval_step, make_schedule, train_step)

__all__ = ["Batch", "LossConfig", "bn_momentum_for_epoch",
           "create_optimizer", "eval_step", "make_schedule", "train_step"]
