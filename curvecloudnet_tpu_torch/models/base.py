"""The step-DSL interpreter (counterpart of
``curvecloudnet_tpu/models/base.py``): runs a :class:`ModelSpec`'s steps
over a batch-padded Cloud with the reference's two skip stacks, then the
head MLP.

* downsampled skips: every ``sa``/``sa-geo`` step pushes its input cloud;
  ``fp``/``fp-geo`` pop and upsample back to it;
* proportional skips: every step named in ``skip_connect_state_store``
  pushes its input features; ``skip-connect`` pops ``num_skips`` of them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.neighbors import TABLE_K, TABLE_MAX_N, TableCache
from .cloud import Cloud
from .layers import MLP
from .modules import (CurveFPStep, CurveSAStep, EdgeConvStep, FPStep,
                      SAStep, SharedMLPStep, SkipConnectStep,
                      SymmetricCurveConvStep)
from .spec import ModelSpec


def row_radius_bounds(spec: ModelSpec):
    """Per step, the radius bound of the shared table of the row it
    searches: the max radius over every 3D same-row table consumer of that
    row, or None when some consumer is unbounded (the first list of
    ``curvecloudnet_tpu.models.base._row_radius_bounds``)."""
    row, next_row = 0, 1
    down_stack, searches, step_row = [], [], []
    for step in spec.steps:
        step_row.append(row)
        if step.name == "sgcnn":
            if step.knn is not None and step.knn <= TABLE_K:
                r = step.radius if step.radius is not None else 1.0
                searches.append((row, None if step.use_sparse_feat_agg else r))
        elif step.name == "sa":
            if step.use_fast_knn and step.knn and step.knn <= TABLE_K:
                searches.append(
                    (row, step.radius if step.radius is not None else 0.25))
            elif step.knn and step.knn <= TABLE_K:
                searches.append((row, None))
        if step.name in ("sa", "sa-geo", "sa-global"):
            down_stack.append(row)
            row, next_row = next_row, next_row + 1
        elif step.name in ("fp", "fp-geo"):
            row = down_stack.pop()
    bounds = {}
    for rid, r in searches:
        if rid in bounds:
            bounds[rid] = (None if bounds[rid] is None or r is None
                           else max(bounds[rid], r))
        else:
            bounds[rid] = r
    return [bounds.get(r) for r in step_row]


def kernel_launches(spec: ModelSpec, n_points: int, train: bool = False):
    """Kernel launches of one eval forward, or with ``train`` of one train
    step (forward + backward), any batch size, derived from the spec.

    Eval: K1 once per conv step, K2 once per grouping step.  Train: per
    grouping step with L kernel-side denses, the K7 forward runs L stats
    passes, one more for the attention BN, and the output pass; its
    backward runs B_att (attend), B_msg and L-1 B_mid passes.  Both: K4
    once per sgcnn step (its self-row gather; K4b once in the backward),
    K6 once per FPS step, K3 once per shared row table and per fp sweep
    (plus once per search on a row too large for a table)."""
    counts = ({"group_train_fwd": 0, "group_train_bwd": 0, "gather": 0,
               "scatter": 0, "knn": 0, "fps": 0} if train else
              {"conv1d_chain": 0, "group_reduce": 0, "gather": 0, "knn": 0,
               "fps": 0})
    bounds = row_radius_bounds(spec)
    sizes, row, down_stack, tables = [n_points], 0, [], set()
    for i, step in enumerate(spec.steps):
        n = sizes[row]
        if step.name == "conv1d-fast-v2" and not train:
            counts["conv1d_chain"] += 1
        if step.name in ("sa", "sa-geo", "sgcnn"):
            if train:
                n_loc = len(spec.input_dim(i)) - 2
                attend = int(step.aggr_type == "attend")
                counts["group_train_fwd"] += n_loc + attend + 1
                counts["group_train_bwd"] += attend + n_loc
            else:
                counts["group_reduce"] += 1
        if step.name == "sgcnn":
            counts["gather"] += 1
            if train:
                counts["scatter"] += 1
        if step.name == "sa" and step.downsample_type == "fps":
            counts["fps"] += 1
        if step.name in ("sa", "sgcnn"):
            if step.knn <= TABLE_K and n <= TABLE_MAX_N:
                tables.add((row, bounds[i]))
            else:
                counts["knn"] += 1
        if step.name == "fp":
            counts["knn"] += 1
        if step.name in ("sa", "sa-geo"):
            down_stack.append(row)
            sizes.append(step.out_budget(n))
            row = len(sizes) - 1
        elif step.name in ("fp", "fp-geo"):
            row = down_stack.pop()
    counts["knn"] += len(tables)
    return counts


class CurveCloudNet(nn.Module):
    """The full network: steps (``steps.{i}``) + head MLP (``mlp``).

    ``feat_channels`` is the width of the input cloud's features (None for
    position-only inputs); ``n_points`` is the padded full-resolution row.
    """

    def __init__(self, spec: ModelSpec, n_points: int, feat_channels=None):
        super().__init__()
        if spec.with_seg_category:
            raise NotImplementedError("the lin_categorical head is not ported")
        self.spec = spec
        bounds = row_radius_bounds(spec)
        steps = []
        widths = []          # x width of each step's input cloud
        w, n_now = feat_channels, n_points
        down_skips, prop_skips = [], []
        for i, step in enumerate(spec.steps):
            dims = spec.input_dim(i)
            widths.append(w)
            name = step.name
            if name == "sa":
                n_now = step.out_budget(n_now)
                mod = SAStep(spec, step, dims, w, n_now, bounds[i])
            elif name == "sa-geo":
                n_now = step.out_budget(n_now)
                mod = CurveSAStep(spec, step, dims, w, n_now)
            elif name in ("fp", "fp-geo"):
                j = down_skips.pop()
                skip_w = 3 if widths[j] is None else widths[j]
                cls = FPStep if name == "fp" else CurveFPStep
                mod = cls(spec, step, dims, w, skip_w)
            elif name == "skip-connect":
                k = step.num_skips or 1
                take, prop_skips = prop_skips[-k:], prop_skips[:-k]
                mod = SkipConnectStep(spec, step, dims, w, [
                    3 if widths[j] is None else widths[j] for j in take])
            elif name == "sgcnn":
                mod = EdgeConvStep(spec, step, dims, w, bounds[i])
            elif name == "conv1d-fast-v2":
                mod = SymmetricCurveConvStep(spec, step, w)
            elif name == "mlp":
                mod = SharedMLPStep(spec, step, dims, w)
            else:
                raise NotImplementedError(f"step {name!r} is not ported")
            steps.append(mod)
            if name in ("sa", "sa-geo"):
                down_skips.append(i)
            if name in spec.skip_connect_state_store:
                prop_skips.append(i)
            w = step.feat_dims[-1]
        self.steps = nn.ModuleList(steps)
        self.in_widths = tuple(widths)   # x width of each step's input cloud
        self.mlp = None
        if not spec.identity_head:
            self.mlp = MLP((w,) + spec.out_mlp_dims + (spec.n_out,),
                           use_bias=spec.use_bias,
                           dropout=spec.out_mlp_dropout)

    @staticmethod
    def _draws(step, cloud: Cloud, generator):
        """A sampling step's uniform draws from ``generator`` (None: the
        deterministic operating point): sa-geo one phase scalar, voxel sa
        one jitter per point, FPS sa one start per sample."""
        if generator is None or step.name not in ("sa", "sa-geo"):
            return None
        b, n = cloud.valid.shape
        shape = (() if step.name == "sa-geo" else
                 (b, n) if step.downsample_type == "voxel" else (b,))
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(cloud.pos.device)

    def forward(self, cloud: Cloud, train: bool = False, bn_momentum=0.1,
                generator: torch.Generator | None = None):
        """Returns (logits (B, N, n_out), valid (B, N)).  ``train`` runs
        BatchNorm on masked batch statistics and updates the running ones
        with ``bn_momentum``; the sampling steps draw from ``generator``
        in step order."""
        tables = TableCache()
        kw = dict(train=train, bn_momentum=bn_momentum)
        input_clouds, down_skips, prop_skips = [], [], []
        for i, (step, mod) in enumerate(zip(self.spec.steps, self.steps)):
            input_clouds.append(cloud)
            name = step.name
            draws = self._draws(step, cloud, generator)
            if name == "sa":
                cloud = mod(cloud, tables, draws=draws, **kw)
            elif name == "sa-geo":
                cloud = mod(cloud, draws=draws, **kw)
            elif name == "sgcnn":
                cloud = mod(cloud, tables, **kw)
            elif name in ("fp", "fp-geo"):
                cloud = mod(cloud, input_clouds[down_skips.pop()], **kw)
            elif name == "skip-connect":
                k = step.num_skips or 1
                take, prop_skips = prop_skips[-k:], prop_skips[:-k]
                cloud = mod(cloud, [
                    input_clouds[j].x if input_clouds[j].x is not None
                    else input_clouds[j].pos for j in take], **kw)
            else:
                cloud = mod(cloud, **kw)
            if name in ("sa", "sa-geo"):
                down_skips.append(i)
            if name in self.spec.skip_connect_state_store:
                prop_skips.append(i)
        x = cloud.x if self.mlp is None else self.mlp(
            cloud.x, mask=cloud.valid, **kw)
        return x, cloud.valid
