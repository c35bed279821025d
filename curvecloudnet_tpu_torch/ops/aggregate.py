"""Masked neighbor-set aggregation over dense (B, Q, K, C) messages
(counterpart of ``curvecloudnet_tpu/ops/aggregate.py``).  Kernels K2 and
K7 fuse ``max`` and ``attend`` into their chains; ``mean`` and
``weighted-sum`` run here in plain torch, as the JAX package runs them in
XLA (its kernel gate admits only max and attend)."""

from __future__ import annotations

import torch

# Mask fills of the reference: SGCNN masked-max fill and attention logit fill
MAX_FILL = -1e2
ATTEND_FILL = -5e2


def masked_max(msgs: torch.Tensor, mask: torch.Tensor,
               fill: float = MAX_FILL) -> torch.Tensor:
    filled = torch.where(mask[..., None], msgs, torch.full_like(msgs, fill))
    return filled.max(dim=-2).values


def masked_mean(msgs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None].to(msgs.dtype)
    return (msgs * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1.0)


def masked_attend(msgs: torch.Tensor, logits: torch.Tensor,
                  mask: torch.Tensor, fill: float = ATTEND_FILL) -> torch.Tensor:
    """Per-channel softmax-attention pooling over the K axis."""
    logits = torch.where(mask[..., None], logits, torch.full_like(logits, fill))
    w = torch.softmax(logits.float(), dim=-2).to(msgs.dtype)
    return (msgs * w).sum(dim=-2)


def masked_weighted_sum(msgs: torch.Tensor, logits: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Sigmoid-gated normalized sum (reference 'weighted-sum',
    dgcnn.py:190-197)."""
    w = torch.where(mask[..., None], torch.sigmoid(logits),
                    torch.zeros_like(logits))
    w = w / torch.clamp(w.sum(dim=-2, keepdim=True), min=1e-3)
    return (msgs * w).sum(dim=-2)


def aggregate(msgs: torch.Tensor, mask: torch.Tensor, aggr_type: str,
              logits: torch.Tensor | None = None) -> torch.Tensor:
    if aggr_type == "max":
        return masked_max(msgs, mask)
    if aggr_type == "mean":
        return masked_mean(msgs, mask)
    if aggr_type == "attend":
        return masked_attend(msgs, logits, mask)
    if aggr_type == "weighted-sum":
        return masked_weighted_sum(msgs, logits, mask)
    raise ValueError(f"unknown aggr_type {aggr_type!r}")
