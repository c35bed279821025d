"""Validity-masked BatchNorm and the PyG-style MLP (counterpart of
``curvecloudnet_tpu/models/layers.py``), in eval and train mode.

Parameter names follow torch_geometric's MLP (``lins.N``, ``norms.N``) so
the reference's released ``state_dict`` loads as it is.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


ACTIVATIONS = {
    "relu": F.relu,
    "leaky_relu": leaky_relu,
    "identity": lambda x: x,
}


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last axis with a validity mask over the leading
    axes.  Eval normalizes with the running statistics; train with the
    masked batch statistics (count clipped to at least 1, biased variance)
    and updates the running ones torch-style with the unbiased variance:
    new = (1 - momentum) * old + momentum * batch."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def affine(self):
        """The eval BN as ``x * s + t``."""
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s

    def batch_stats(self, x: torch.Tensor, mask=None):
        """(mean, biased var, count) over the masked rows of x (..., C)."""
        c = x.shape[-1]
        xf = x.reshape(-1, c).float()
        if mask is None:
            cnt = xf.new_full((), float(xf.shape[0]))  # no host copy
            mean = xf.mean(dim=0)
            return mean, ((xf - mean) ** 2).mean(dim=0), cnt
        mf = mask.reshape(-1, 1).float()
        cnt = torch.clamp(mf.sum(), min=1.0)
        mean = (xf * mf).sum(dim=0) / cnt
        return mean, ((xf - mean) ** 2 * mf).sum(dim=0) / cnt, cnt

    @torch.no_grad()
    def update_running(self, mean, var, cnt, momentum) -> None:
        unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
        self.running_mean.copy_((1 - momentum) * self.running_mean
                                + momentum * mean)
        self.running_var.copy_((1 - momentum) * self.running_var
                               + momentum * unbiased)

    def forward(self, x: torch.Tensor, mask=None, train: bool = False,
                momentum=0.1, stats_override=None,
                update_running: bool = True) -> torch.Tensor:
        """``stats_override=(mean, var, count)`` supplies batch statistics
        computed elsewhere (kernel K7); they stay differentiable.
        ``update_running=False`` skips the running-stat write."""
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var, cnt = (stats_override if stats_override is not None
                              else self.batch_stats(x, mask))
            if update_running:
                self.update_running(mean.detach(), var.detach(),
                                    cnt.detach(), momentum)
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class MLP(nn.Module):
    """[Linear -> BN -> act]* -> Linear (plain last unless ``plain_last`` is
    False) over the last axis of (..., C) tensors.  ``dims[0]`` is the
    input width."""

    def __init__(self, dims: Sequence[int], act: str = "relu",
                 use_bias: bool = False, plain_last: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.dims = tuple(dims)
        self.dropout = dropout
        self.act = act
        n = len(dims) - 1
        self.n_norms = n - 1 if plain_last else n
        self.lins = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], bias=use_bias) for i in range(n))
        self.norms = nn.ModuleList(
            MaskedBatchNorm(dims[i + 1]) for i in range(self.n_norms))

    def forward(self, x: torch.Tensor, mask=None, train: bool = False,
                bn_momentum=0.1, bn_stats=None, upto: int | None = None,
                first: torch.Tensor | None = None,
                update_running: bool = True, generator=None,
                dropout_masks=None) -> torch.Tensor:
        """``upto=i`` returns layer i's pre-norm output; ``first`` replaces
        layer 0's ``lin_0(x)`` (the edge conv's matmul-before-gather);
        ``bn_stats[i]`` overrides layer i's batch statistics in train.

        With ``dropout`` > 0, train mode drops each hidden layer's
        activation and the last layer's input (with ``plain_last``), as
        flax's ``nn.Dropout`` in the JAX package's MLP: kept values are
        divided by the keep rate.  Each drop's keep-mask is drawn as
        ``rand < keep rate`` from ``generator`` (the global generator when
        None), or taken in order from ``dropout_masks`` (a list of bool
        tensors of the activations' shapes, True = kept)."""
        act = ACTIVATIONS[self.act]
        masks = iter(dropout_masks) if dropout_masks is not None else None
        n = len(self.lins)

        def drop(x):
            if not train or self.dropout <= 0:
                return x
            keep = 1.0 - self.dropout
            if masks is not None:
                kept = next(masks)
            else:
                dev = x.device if generator is None else generator.device
                kept = (torch.rand(x.shape, generator=generator, device=dev)
                        < keep).to(x.device)
            return torch.where(kept, x / keep, torch.zeros_like(x))

        for i, lin in enumerate(self.lins):
            if i == n - 1 and self.n_norms < n:
                x = drop(x)
            x = first if (i == 0 and first is not None) else lin(x)
            if upto is not None and i == upto:
                return x
            if i < self.n_norms:
                x = drop(act(self.norms[i](
                    x, mask=mask, train=train, momentum=bn_momentum,
                    stats_override=None if bn_stats is None else bn_stats[i],
                    update_running=update_running)))
        return x
