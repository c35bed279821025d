"""Step modules (counterpart of ``curvecloudnet_tpu/models/modules.py``),
eval and train.

Each module maps a batch-padded :class:`Cloud` to a new Cloud.  Every
grouping family (sa-geo curve windows, sa neighborhoods, sgcnn / dgcnn
edges) builds its layer-0 messages with one plain matmul, k-major
``(B, K, M, C1)``, and hands the rest of its MLP and the masked
aggregation to kernel K2 (``ops/group_reduce.py``) in eval, kernel K7
(``ops/group_train.py``) in train, where :func:`kernel_grouped` admits
the step (max or attend, and in train a dense past layer 0, the JAX
package's kernel gate); other steps (mean, weighted-sum, a one-layer MLP
in train) run it in plain torch, as the JAX package runs them in XLA.
In train every BatchNorm normalizes with masked batch statistics and
updates its running statistics.  Module and parameter names follow the
reference's torch ``state_dict`` (``checkpoint.py``).

Constructors take the actual incoming feature width ``c_in`` (None when
the cloud carries no features); the spec's declared input widths are
documentation, as in the JAX package where flax infers them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import (aggregate, conv1d_chain, conv1d_train, curve1d,
                   edge_mlp, group_reduce, group_train, interpolate,
                   neighbors, sampling, segments, telemetry)
from .cloud import Cloud
from .layers import MLP, MaskedBatchNorm, leaky_relu
from .spec import ModelSpec, StepSpec


def xyz_width(c_in: Optional[int], with_xyz: bool) -> Optional[int]:
    """Width of ``Cloud.xyz_concat``."""
    if not with_xyz:
        return c_in
    return 3 if c_in is None else c_in + 3


def attend_dims(spec: ModelSpec, step: StepSpec, d: int):
    """Attention-MLP widths (reference base.py:89-92,106-108,113-115)."""
    if step.name == "sa" and spec.version == 2.0:
        return (d, d // 2, d)
    return (d, d, d)


# the steps whose neighbor sets come from an edge convolution
EDGE_STEPS = ("sgcnn", "dgcnn", "dgcnn-rad")


def kernel_grouped(aggr: str, n_lins: int, train: bool) -> bool:
    """Whether a grouping step with an MLP of ``n_lins`` dense layers runs
    on K2 (eval) or K7 (train): max or attend, and in train a dense past
    layer 0 (the JAX package's gate, its ``modules.py:78-81,133-136``)."""
    return aggr in ("max", "attend") and (not train or n_lins >= 2)


def _grouped_plain(h1, mask, local_nn: MLP, attend_nn: Optional[MLP],
                   aggr: str, train: bool, bn_momentum):
    """The MLP past layer 0 and the aggregation in plain torch over the
    query-major (B, M, K) slab, BN statistics over its masked rows (the
    JAX package's XLA path)."""
    msg = local_nn(None, mask=mask, train=train, bn_momentum=bn_momentum,
                   first=h1.permute(0, 2, 1, 3))
    logits = (attend_nn(msg, mask=mask, train=train, bn_momentum=bn_momentum)
              if attend_nn is not None else None)
    return aggregate.aggregate(msg, mask, aggr, logits)


def _grouped(h1, mask, local_nn: MLP, attend_nn: Optional[MLP], aggr: str,
             train: bool = False, bn_momentum=0.1):
    """Layer-0 messages (B, K, M, C1) and the mask (B, M, K) -> the MLP's
    remaining layers and the masked aggregation over K -> (B, M, C_out):
    kernel K2 in eval, kernel K7 in train where :func:`kernel_grouped`
    admits them, else plain torch.  In train the running statistics are
    written from K7's batch statistics, through each BN with
    ``stats_override``."""
    if not kernel_grouped(aggr, len(local_nn.lins), train):
        return _grouped_plain(h1, mask, local_nn, attend_nn, aggr, train,
                              bn_momentum)
    if train:
        out, loc, att = group_train.group_train_reduce(
            h1, mask, local_nn, attend_nn, aggr=aggr, act=local_nn.act)
        pairs = list(zip(local_nn.norms, loc))
        if attend_nn is not None:
            pairs += list(zip(attend_nn.norms, att))
        with torch.no_grad():
            for norm, st in pairs:
                norm(st[0][None], train=True, momentum=bn_momentum,
                     stats_override=st, update_running=True)
        return out
    aff, local = group_reduce.fold_mlp_eval(local_nn)
    att = (group_reduce.fold_full_mlp_eval(attend_nn)
           if attend_nn is not None else None)
    act = local_nn.act if len(local_nn.lins) > 1 else "identity"
    return group_reduce.group_reduce(h1, mask, aff, local, att, aggr=aggr,
                                     act=act, attend_act="leaky_relu")


class PointConv(nn.Module):
    """Holder of the PointNetConv MLPs (reference ``conv.local_nn`` /
    ``conv.attend_nn``)."""

    def __init__(self, local_nn: MLP, attend_nn: Optional[MLP]):
        super().__init__()
        self.local_nn = local_nn
        self.attend_nn = attend_nn


def _attend_mlp(spec, step, d: int) -> Optional[MLP]:
    """The attention MLP of an ``attend`` or ``weighted-sum`` step."""
    if step.aggr_type not in ("attend", "weighted-sum"):
        return None
    return MLP(attend_dims(spec, step, d), act="leaky_relu",
               use_bias=spec.use_bias)


def _point_conv(spec, step, dims, act: str) -> PointConv:
    return PointConv(MLP(dims, act=act, use_bias=spec.use_bias),
                     _attend_mlp(spec, step, dims[-1]))


def _flat_layer0(mlp: MLP, msg: torch.Tensor) -> torch.Tensor:
    """Layer 0 of ``mlp`` as one matmul over a (B, K, M, C) message slab."""
    b, k, m, c = msg.shape
    return mlp(msg.reshape(b, k * m, c), upto=0).reshape(b, k, m, -1)


class SymmetricCurveConvStep(nn.Module):
    """Symmetric 1D convolution along curves (reference fast_conv1d.py).
    Taps are stored as (O, I, h+1) weights (``conv_modules.j``) with
    BatchNorm ``norm_modules.j``.

    conv1d-fast-v2 convolves one zero-stuffed sequence through all layers
    (fast_conv1d.py:49-74): kernel K1 in eval, kernel K8 in train.
    conv1d-fast-v1 re-stuffs the zeros and recomputes the feature diffs
    before every layer (fast_conv1d.py:129-143), so each curve convolves
    alone: same-curve windows (``curve1d.symmetric_window_concat``), one
    ``torch.matmul``, masked BN (batch statistics of the valid points in
    train) and leaky ReLU a layer, in eval and train (the JAX package runs
    it outside any Pallas kernel too).  With ``with_diff`` the
    input width I of every v1 layer is twice its feature width.  A v2
    step of one tap (``kernel_size`` 1: no window crosses a gap) takes
    the same per-curve route, its diffs concatenated before the first
    layer only, as the JAX package's ``half_k == 0`` route."""

    def __init__(self, spec: ModelSpec, step: StepSpec, c_in: Optional[int]):
        super().__init__()
        if step.name not in ("conv1d-fast-v1", "conv1d-fast-v2"):
            raise NotImplementedError(f"{step.name} is not ported")
        self.spec, self.step = spec, step
        self.name = step.name   # telemetry's; the model's "step_{i}_{name}"
        self.v1 = step.name == "conv1d-fast-v1"
        self.half_k = (step.kernel_size or 5) // 2
        self.per_curve = self.v1 or self.half_k == 0
        cx = xyz_width(c_in, step.with_xyz)
        outs = list(step.feat_dims)
        ins = [cx] + outs[:-1]
        if step.with_diff:     # v1 concatenates the diffs before each layer
            ins = [2 * w if self.v1 or j == 0 else w
                   for j, w in enumerate(ins)]
        self.conv_modules = nn.ModuleList(
            _Taps(i, o, self.half_k + 1) for i, o in zip(ins, outs))
        self.norm_modules = nn.ModuleList(MaskedBatchNorm(w) for w in outs)

    def forward(self, cloud: Cloud, train: bool = False,
                bn_momentum=0.1) -> Cloud:
        if self.per_curve:
            return cloud.with_features(self._v1(cloud, train, bn_momentum))
        step = self.step
        cid, valid = cloud.curve_id, cloud.valid
        x = cloud.xyz_concat(step.with_xyz)
        if step.with_diff:
            x = torch.cat([x, curve1d.feature_diffs(x, cid, valid)], dim=-1)
        x = x * valid[..., None].to(x.dtype)
        pad = self.half_k * len(self.conv_modules)
        exp_idx, n_exp, used = curve1d.gap_expand_indices(
            cid, valid, pad, self.spec.curve_budget)
        if telemetry.active():
            # curves past the gap layout's budget (JAX's TPU kernel path
            # records this key alone; its CPU halo path also compacts the
            # curve starts, which the port does not)
            n_curves = (segments.curve_starts(cid, valid) & valid).sum(-1)
            over = n_curves - 1 - self.spec.curve_budget
            telemetry.record(f"{self.name}/curve_budget_overflow",
                             torch.clamp(over, min=0).sum())
        xe = curve1d.gap_scatter(x, exp_idx, n_exp)
        if train:
            return cloud.with_features(curve1d.gap_gather(
                self._train_chain(xe, used, bn_momentum), exp_idx, valid))
        weights = conv1d_chain.fold_conv_bn_eval(self.conv_modules,
                                                 self.norm_modules)
        out = conv1d_chain.conv1d_chain_eval(xe, weights, used, self.half_k)
        return cloud.with_features(curve1d.gap_gather(out, exp_idx, valid))

    def _v1(self, cloud: Cloud, train: bool, bn_momentum) -> torch.Tensor:
        cid, valid = cloud.curve_id, cloud.valid
        x = cloud.xyz_concat(self.step.with_xyz)
        for j, (conv, norm) in enumerate(zip(self.conv_modules,
                                             self.norm_modules)):
            if self.step.with_diff and (self.v1 or j == 0):
                x = torch.cat([x, curve1d.feature_diffs(x, cid, valid)], -1)
            o, i, taps = conv.weight.shape
            w = conv.weight.permute(2, 1, 0).reshape(taps * i, o)
            xw = curve1d.symmetric_window_concat(x, cid, valid, self.half_k)
            x = leaky_relu(norm(xw @ w + conv.bias, mask=valid, train=train,
                                momentum=bn_momentum))
        return x * valid[..., None].to(x.dtype)

    def _train_chain(self, xe, used, bn_momentum):
        """Kernel K8 over the gap layout: BN statistics over every live slot,
        gap slots included (the JAX package's ``mask_exp``); the running
        statistics are written from K8's batch statistics, as ``_grouped``
        does for K7."""
        params = []
        for conv, norm in zip(self.conv_modules, self.norm_modules):
            o, i, taps = conv.weight.shape
            params.append((conv.weight.permute(2, 1, 0).reshape(taps * i, o),
                           conv.bias, norm.weight, norm.bias))
        out, stats = conv1d_train.conv1d_chain_train(xe, params, used,
                                                     self.half_k)
        with torch.no_grad():
            for norm, st in zip(self.norm_modules, stats):
                norm(st[0][None], train=True, momentum=bn_momentum,
                     stats_override=st, update_running=True)
        return out


class _Taps(nn.Module):
    """Symmetric conv taps w_0..w_h as the reference's (O, I, h+1) weight."""

    def __init__(self, c_in: int, c_out: int, taps: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, taps))
        self.bias = nn.Parameter(torch.zeros(c_out))


class CurveSAStep(nn.Module):
    """sa-geo: arclength sampling (FPS at ``ratio``, kernel K6, without
    ``use_curve_fps``) + geodesic radius grouping along curves (reference
    pointnet2.py:146-181)."""

    def __init__(self, spec, step, dims, c_in, budget: int):
        super().__init__()
        self.step, self.budget = step, budget
        cx = xyz_width(c_in, step.with_xyz)
        msg_w = 3 if cx is None else cx + 3
        self.conv = _point_conv(spec, step, (msg_w,) + tuple(dims[1:]),
                                act="leaky_relu")

    def forward(self, cloud: Cloud, train: bool = False, bn_momentum=0.1,
                draws=None) -> Cloud:
        step, w = self.step, self.step.curve_window
        cloud = cloud.with_features(cloud.xyz_concat(step.with_xyz))
        if step.use_curve_fps:
            idx, idx_valid = sampling.curve_fps(
                cloud.pos, cloud.curve_id, cloud.valid, step.curve_fps_arclen,
                self.budget, u=draws)
        else:
            idx, idx_valid = sampling.fps(cloud.pos, cloud.valid, step.ratio,
                                          self.budget, u=draws)
        down = cloud.gather(idx, idx_valid)
        _, nbr_mask = curve1d.radius_1d_group_subset(
            cloud.pos, idx, down.valid, cloud.curve_id, cloud.valid,
            step.radius, w)
        rel = curve1d.window_rows(cloud.pos, idx, w) - down.pos[:, None]
        if step.normalize_radius and step.radius:
            rel = rel / step.radius
        msg = rel if cloud.x is None else torch.cat(
            [curve1d.window_rows(cloud.x, idx, w), rel], dim=-1)
        h1 = _flat_layer0(self.conv.local_nn, msg)
        mask = curve1d.ascending_from_interleaved(nbr_mask, w)
        return down.with_features(_grouped(
            h1, mask, self.conv.local_nn, self.conv.attend_nn, step.aggr_type,
            train, bn_momentum))


def downsample(step: StepSpec, cloud: Cloud, budget: int, draws=None):
    """An sa step's sampler by ``downsample_type`` (the JAX package's
    ``_downsample``): voxel, arclength (curve-fps), random, or FPS (kernel
    K6), each fed its uniform draws."""
    kind = step.downsample_type
    if kind == "voxel":
        return sampling.voxel_downsample(cloud.pos, cloud.valid,
                                         step.voxel_size, budget, u=draws)
    if kind == "curve-fps":
        return sampling.curve_fps(cloud.pos, cloud.curve_id, cloud.valid,
                                  step.curve_fps_arclen, budget, u=draws)
    if kind == "random":
        return sampling.random_downsample(cloud.valid, step.ratio, budget,
                                          u=draws)
    return sampling.fps(cloud.pos, cloud.valid, step.ratio, budget, u=draws)


class SAStep(nn.Module):
    """PointNet++ set abstraction (reference pointnet2.py:33-78): voxel,
    arclength, random or FPS downsampling (:func:`downsample`), kNN
    grouping from the row table (exact, or the grid table at
    ``grid_bound`` / ``grid_cap`` on a row above
    ``neighbors.TABLE_MAX_N``), PointNetConv.  A step with no ``knn`` and
    no fast kNN groups by ball query instead: the 128 nearest points
    within ``radius`` (``neighbors.ball_query``, kernel K3 at k = 128,
    no gradient), grouped by K2 in eval and K7 in train."""

    BALL_K = 128   # the reference's ball-query cap (point_ops.py:81)

    def __init__(self, spec, step, dims, c_in, budget: int, table_bound,
                 grid_bound=None, grid_cap=None):
        super().__init__()
        self.ball = not step.use_fast_knn and step.knn is None
        if not (self.ball or step.knn):
            raise NotImplementedError("sa with fast kNN needs a knn")
        if self.ball and step.radius is None:
            raise ValueError("sa ball grouping needs a radius")
        self.step, self.budget = step, budget
        self.table_bound, self.grid_bound, self.grid_cap = (
            table_bound, grid_bound, grid_cap)
        msg_w = 3 if c_in is None else c_in + 3
        self.conv = _point_conv(spec, step, (msg_w,) + tuple(dims[1:]),
                                act="relu")

    def forward(self, cloud: Cloud, tables, train: bool = False,
                bn_momentum=0.1, draws=None) -> Cloud:
        step = self.step
        idx, idx_valid = downsample(step, cloud, self.budget, draws)
        down = cloud.gather(idx, idx_valid)
        if self.ball:
            nbr_idx, _ = neighbors.ball_query(down.pos, cloud.pos, down.valid,
                                              cloud.valid, step.radius,
                                              self.BALL_K)
        else:
            radius = None
            if step.use_fast_knn:
                radius = step.radius if step.radius is not None else 0.25
            nbr_idx, _ = neighbors.subset_knn(
                cloud.pos, cloud.valid, idx, down.valid, step.knn,
                radius=radius, table_bound=self.table_bound,
                grid_bound=self.grid_bound, grid_cap=self.grid_cap,
                tables=tables)
        idx_km = nbr_idx.transpose(1, 2)                         # (B, K, M)
        rel = (neighbors.gather_neighbors(cloud.pos, idx_km, fill=train)
               - down.pos[:, None])
        if step.normalize_radius and step.radius:
            rel = rel / step.radius
        msg = rel if cloud.x is None else torch.cat(
            [neighbors.gather_neighbors(cloud.x, idx_km, fill=train), rel],
            dim=-1)
        h1 = _flat_layer0(self.conv.local_nn, msg)
        return down.with_features(_grouped(
            h1, (nbr_idx >= 0).contiguous(), self.conv.local_nn,
            self.conv.attend_nn, step.aggr_type, train, bn_momentum))


EDGE_ROUTES = ("group", "fused")


def fused_edge_admits(dims, aggr: str) -> bool:
    """The JAX package's gate for its fused edge kernel (modules.py:
    715-721): max aggregation, and every width of the edge MLP ``dims``
    (its input 2C included) at most 512; its other bound, x at most 300
    wide, follows from 2C <= 512."""
    return aggr == "max" and max(dims) <= 512


def edge_widths(step: StepSpec, dims, c_in: Optional[int]):
    """An edge step's (search width, MLP widths) on a cloud whose features
    are ``c_in`` wide: its messages are twice ``Cloud.xyz_concat``'s width,
    and lin_0 takes that, as flax sizes it (the spec's ``dims[0]`` is
    ``in_dim`` for a first dgcnn-rad step); dgcnn searches in the space of
    ``xyz_concat``."""
    cx = xyz_width(c_in, step.with_xyz)
    return cx, (2 * cx,) + tuple(dims[1:])


class EdgeConvStep(nn.Module):
    """sgcnn / dgcnn edge convolution (reference dgcnn.py:98-266).

    sgcnn's fast message order [x_j, x_i - x_j] (dgcnn.py:158-207) takes
    the row table at the step's radius plus a self loop.  With
    ``use_sparse_feat_agg`` the slow order [x_i, x_j - x_i] (dgcnn.py:
    209-266) takes an exact, unbounded kNN table with no self loop.
    dgcnn and dgcnn-rad take the slow order over a dynamic graph: the
    ``knn`` nearest points, or the 128 nearest within ``radius``, in the
    space of [x, pos] (``with_xyz``; x alone otherwise), the positions
    kept in float32 (``neighbors.feature_knn``: K3 for a 3-D search, a
    plain torch search for a wider one, as the JAX package).  Any order
    may aggregate by attention (``attend_nn``); in train max and attend
    run on K7 (the JAX package takes its XLA path for attend: the same
    masked batch statistics); mean and weighted-sum run in plain torch
    (:func:`_grouped`).  Layer 0
    re-associates as gather(x @ (Wt - Wb)) + x_i @ Wb (+ b) in the fast
    order and as gather(x @ Wb) + x_i @ (Wt - Wb) (+ b) in the slow one, so
    the (B, N, K, 2C) message concat never materializes.  The ``group``
    route computes the two products with ``torch.matmul``, gathers the
    first with K4 and runs the rest in K2.  With ``edge_kernel="fused"``,
    eval runs the whole step in kernel K9 (``ops/edge_mlp.py``, the slow
    order folded into W_0) where :func:`fused_edge_admits` the widths and
    the aggregation: the same two products once a point in its own
    projection, then the later layers and the masked max on K2's live-row
    chain, the layer-0 rows built in shared memory; train always takes
    K4/K4b + K7."""

    BALL_K = 128   # dgcnn-rad's cap (reference DynamicEdgeConv)

    def __init__(self, spec, step, dims, c_in, table_bound, grid_bound=None,
                 grid_cap=None, edge_kernel: str = "group"):
        super().__init__()
        if step.name not in EDGE_STEPS:
            raise NotImplementedError(f"{step.name} is not ported")
        if edge_kernel not in EDGE_ROUTES:
            raise ValueError(f"edge_kernel {edge_kernel!r}: one of "
                             f"{EDGE_ROUTES}")
        self.step = step
        self.feature_space = step.name != "sgcnn"
        self.slow = self.feature_space or step.use_sparse_feat_agg
        self.table_bound, self.grid_bound, self.grid_cap = (
            table_bound, grid_bound, grid_cap)
        self.nn = MLP(edge_widths(step, dims, c_in)[1],
                      use_bias=spec.use_bias)
        self.attend_nn = _attend_mlp(spec, step, dims[-1])
        self.fused = edge_kernel == "fused" and fused_edge_admits(
            self.nn.dims, step.aggr_type)

    def layer0(self, x):
        """The group route's layer 0, two products a point: (the gathered
        one, the query's one + b_0): (x (Wt - Wb), x Wb + b_0) in the fast
        order, (x Wb, x (Wt - Wb) + b_0) in the slow one
        (``edge_mlp.layer0_split``)."""
        lin0 = self.nn.lins[0]
        w_u, w_v = edge_mlp.layer0_split(lin0.weight.t())
        if self.slow:
            w_u, w_v = w_v, w_u
        v = x @ w_v
        return x @ w_u, v + lin0.bias if lin0.bias is not None else v

    def forward(self, cloud: Cloud, tables, train: bool = False,
                bn_momentum=0.1) -> Cloud:
        step = self.step
        x = cloud.xyz_concat(step.with_xyz)
        if self.feature_space:
            rad = step.name == "dgcnn-rad"
            nbr_idx, _ = neighbors.feature_knn(
                x, cloud.valid, self.BALL_K if rad else step.knn,
                step.radius if rad else None)
        elif self.slow:
            nbr_idx, _ = neighbors.same_set_knn(
                cloud.pos, cloud.valid, step.knn,
                table_bound=self.table_bound, tables=tables)
        else:
            r = step.radius if step.radius is not None else 1.0
            nbr_idx, _ = neighbors.same_set_knn(
                cloud.pos, cloud.valid, step.knn, radius=r,
                table_bound=self.table_bound, grid_bound=self.grid_bound,
                grid_cap=self.grid_cap, tables=tables)
            nbr_idx = neighbors.add_self_loops(nbr_idx, cloud.valid)
        valid = cloud.valid[..., None]
        if self.fused and not train:
            out = edge_mlp.fused_edge_mlp_max(
                x, nbr_idx, *edge_mlp.fold_edge_mlp_eval(self.nn, self.slow))
            return cloud.with_features(out * valid.to(out.dtype))
        u, v = self.layer0(x)
        # the k-major self-row gather: kernels K4 / K4b
        first = (neighbors.gather_neighbors(
            u, nbr_idx.transpose(1, 2).contiguous(), fill=train, layout="kq")
            + v[:, None])
        out = _grouped(first.contiguous(), (nbr_idx >= 0).contiguous(),
                       self.nn, self.attend_nn, step.aggr_type, train,
                       bn_momentum)
        return cloud.with_features(out * valid.to(out.dtype))


class GlobalSAStep(nn.Module):
    """sa-global: an MLP over [x, pos], then a masked max or mean over
    each sample's points, giving a one-point cloud (reference
    pointnet2.py:81-116); plain torch, as the JAX package runs no kernel
    here.  In train the MLP's BatchNorms take the valid points' batch
    statistics; the max splits a tie's gradient evenly (as ``jnp.max``),
    and the -1e30 fill of padded rows takes none of it."""

    def __init__(self, spec, step, dims, c_in: int):
        super().__init__()
        self.step = step
        self.nn = MLP((c_in + 3,) + tuple(dims[1:]), use_bias=spec.use_bias)

    def forward(self, cloud: Cloud, train: bool = False,
                bn_momentum=0.1) -> Cloud:
        valid = cloud.valid
        x = self.nn(torch.cat([cloud.x, cloud.pos.to(cloud.x.dtype)], -1),
                    mask=valid, train=train, bn_momentum=bn_momentum)
        mask = valid[..., None]
        if self.step.pooling == "mean":
            pooled = (torch.where(mask, x, torch.zeros_like(x)).sum(1)
                      / torch.clamp(mask.sum(1), min=1).to(x.dtype))
        else:
            pooled = torch.where(mask, x, torch.full_like(x, -1e30)).amax(1)
        b = valid.shape[0]
        return Cloud(pos=cloud.pos[:, :1], valid=valid.any(1, keepdim=True),
                     curve_id=cloud.curve_id[:, :1], x=pooled[:, None],
                     parent_idx=torch.zeros((b, 1), dtype=torch.int32,
                                            device=valid.device))


class SharedMLPStep(nn.Module):
    """Pointwise MLP with optional xyz concat (reference mlp.py:5-22)."""

    def __init__(self, spec, step, dims, c_in):
        super().__init__()
        self.step = step
        cx = xyz_width(c_in, step.with_xyz)
        self.mlp = MLP((cx,) + tuple(dims[1:]), act=step.act or "leaky_relu",
                       use_bias=spec.use_bias, plain_last=step.plain_last)

    def forward(self, cloud: Cloud, train: bool = False,
                bn_momentum=0.1) -> Cloud:
        return cloud.with_features(self.mlp(
            cloud.xyz_concat(self.step.with_xyz), mask=cloud.valid,
            train=train, bn_momentum=bn_momentum))


class SkipConnectStep(nn.Module):
    """Concat skip features + MLP (reference skip_connect.py:6-15)."""

    def __init__(self, spec, step, dims, c_in: int, skip_widths: Sequence[int]):
        super().__init__()
        self.nn = MLP((c_in + sum(skip_widths),) + tuple(dims[1:]),
                      act="leaky_relu", use_bias=spec.use_bias)

    def forward(self, cloud: Cloud, skips, train: bool = False,
                bn_momentum=0.1) -> Cloud:
        return cloud.with_features(self.nn(
            torch.cat([cloud.x] + list(skips), -1), mask=cloud.valid,
            train=train, bn_momentum=bn_momentum))


class FPStep(nn.Module):
    """Feature propagation upsample (reference pointnet2.py:119-143); the
    3-NN sources are the subset ``parent_idx`` of the skip row, or, for a
    cloud with no ``parent_idx``, any points (``knn_interpolate``, K3 over
    the whole row)."""

    def __init__(self, spec, step, dims, c_in: int, skip_width: int,
                 act: str = "relu"):
        super().__init__()
        self.step = step
        width = c_in + skip_width + (3 if step.with_xyz else 0)
        self.nn = MLP((width,) + tuple(dims[1:]), act=act,
                      use_bias=spec.use_bias)

    def _upsample(self, cloud: Cloud, skip: Cloud, k: int):
        if cloud.parent_idx is None:
            return interpolate.knn_interpolate(cloud.x, cloud.pos,
                                               cloud.valid, skip.pos,
                                               skip.valid, k=k)
        return interpolate.knn_interpolate_subset(
            cloud.x, cloud.parent_idx, cloud.valid, skip.pos, skip.valid, k=k,
            cand_pos=cloud.pos)

    def forward(self, cloud: Cloud, skip: Cloud, train: bool = False,
                bn_momentum=0.1) -> Cloud:
        x = self._upsample(cloud, skip, self.step.knn or 3)
        parts = [x, skip.x if skip.x is not None else skip.pos]
        if self.step.with_xyz:
            parts.append(skip.pos)
        return skip.with_features(self.nn(
            torch.cat(parts, dim=-1), mask=skip.valid, train=train,
            bn_momentum=bn_momentum))


class CurveFPStep(FPStep):
    """Geodesic upsample along curves (reference pointnet2.py:184-205)."""

    def __init__(self, spec, step, dims, c_in: int, skip_width: int):
        super().__init__(spec, step, dims, c_in, skip_width, act="leaky_relu")

    def _upsample(self, cloud: Cloud, skip: Cloud, k: int):
        return interpolate.knn_interpolate_1d(
            cloud.x, cloud.parent_idx, cloud.valid, skip.pos, skip.curve_id,
            skip.valid, k=k)
