"""Step modules (counterpart of ``curvecloudnet_tpu/models/modules.py``),
eval and train.

Each module maps a batch-padded :class:`Cloud` to a new Cloud.  Every
grouping family (sa-geo curve windows, sa neighborhoods, sgcnn edges)
builds its layer-0 messages with one plain matmul, k-major ``(B, K, M, C1)``,
and hands the rest of its MLP and the masked aggregation to kernel K2
(``ops/group_reduce.py``) in eval, kernel K7 (``ops/group_train.py``) in
train.  In train every BatchNorm normalizes with masked batch statistics
and updates its running statistics.  Module and parameter names follow the
reference's torch ``state_dict`` (``checkpoint.py``).

Constructors take the actual incoming feature width ``c_in`` (None when
the cloud carries no features); the spec's declared input widths are
documentation, as in the JAX package where flax infers them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import (conv1d_chain, curve1d, group_reduce, group_train,
                   interpolate, neighbors, sampling)
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


def _check_aggr(step: StepSpec):
    if step.aggr_type not in ("max", "attend"):
        raise NotImplementedError(
            f"{step.name}: aggr_type {step.aggr_type!r} is not ported")


def _grouped(h1, mask, local_nn: MLP, attend_nn: Optional[MLP], aggr: str,
             train: bool = False, bn_momentum=0.1):
    """Layer-0 messages (B, K, M, C1) -> the MLP's remaining layers and the
    masked aggregation over K -> (B, M, C_out): kernel K2 in eval, kernel
    K7 in train.  In train the running statistics are written from K7's
    batch statistics, through each BN with ``stats_override``."""
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


def _point_conv(spec, step, dims, act: str) -> PointConv:
    _check_aggr(step)
    use_bias = spec.use_bias
    attend = (MLP(attend_dims(spec, step, dims[-1]), act="leaky_relu",
                  use_bias=use_bias) if step.aggr_type == "attend" else None)
    return PointConv(MLP(dims, act=act, use_bias=use_bias), attend)


def _flat_layer0(mlp: MLP, msg: torch.Tensor) -> torch.Tensor:
    """Layer 0 of ``mlp`` as one matmul over a (B, K, M, C) message slab."""
    b, k, m, c = msg.shape
    return mlp(msg.reshape(b, k * m, c), upto=0).reshape(b, k, m, -1)


class SymmetricCurveConvStep(nn.Module):
    """conv1d-fast-v2: symmetric 1D convolution along curves over the
    reference's zero-stuffed sequence (reference fast_conv1d.py:49-74).
    Taps are stored as (O, I, h+1) weights (``conv_modules.j``) with
    BatchNorm ``norm_modules.j``; the chain runs in kernel K1."""

    def __init__(self, spec: ModelSpec, step: StepSpec, c_in: Optional[int]):
        super().__init__()
        if step.name != "conv1d-fast-v2":
            raise NotImplementedError(f"{step.name} is not ported")
        self.spec, self.step = spec, step
        self.half_k = (step.kernel_size or 5) // 2
        if self.half_k < 1:
            raise NotImplementedError("conv1d-fast-v2 with kernel_size < 3")
        cx = xyz_width(c_in, step.with_xyz)
        widths = [2 * cx if step.with_diff else cx] + list(step.feat_dims)
        self.conv_modules = nn.ModuleList(
            _Taps(widths[j], widths[j + 1], self.half_k + 1)
            for j in range(len(widths) - 1))
        self.norm_modules = nn.ModuleList(
            MaskedBatchNorm(w) for w in widths[1:])

    def forward(self, cloud: Cloud, train: bool = False,
                bn_momentum=0.1) -> Cloud:
        step = self.step
        cid, valid = cloud.curve_id, cloud.valid
        x = cloud.xyz_concat(step.with_xyz)
        if step.with_diff:
            x = torch.cat([x, curve1d.feature_diffs(x, cid, valid)], dim=-1)
        x = x * valid[..., None].to(x.dtype)
        pad = self.half_k * len(self.conv_modules)
        exp_idx, n_exp, used = curve1d.gap_expand_indices(
            cid, valid, pad, self.spec.curve_budget)
        xe = curve1d.gap_scatter(x, exp_idx, n_exp)
        if train:
            return cloud.with_features(curve1d.gap_gather(
                self._train_chain(xe, used, bn_momentum), exp_idx, valid))
        weights = conv1d_chain.fold_conv_bn_eval(self.conv_modules,
                                                 self.norm_modules)
        out = conv1d_chain.conv1d_chain_eval(xe, weights, used, self.half_k)
        return cloud.with_features(curve1d.gap_gather(out, exp_idx, valid))

    def _train_chain(self, xe, used, bn_momentum):
        """The plain expanded chain (K8 is off by default in the JAX
        package): BN statistics over every live slot of the gap layout,
        gap slots included (the JAX package's ``mask_exp``)."""
        live = (torch.arange(xe.shape[1], device=xe.device)[None, :]
                < used[:, None].long())
        for conv, norm in zip(self.conv_modules, self.norm_modules):
            o, i, taps = conv.weight.shape
            w = conv.weight.permute(2, 1, 0).reshape(taps * i, o)
            xe = curve1d.window_concat_nomask(xe, self.half_k) @ w + conv.bias
            xe = leaky_relu(norm(xe, mask=live, train=True,
                                 momentum=bn_momentum))
            xe = xe * live[..., None].to(xe.dtype)
        return xe


class _Taps(nn.Module):
    """Symmetric conv taps w_0..w_h as the reference's (O, I, h+1) weight."""

    def __init__(self, c_in: int, c_out: int, taps: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, taps))
        self.bias = nn.Parameter(torch.zeros(c_out))


class CurveSAStep(nn.Module):
    """sa-geo: arclength sampling + geodesic radius grouping along curves
    (reference pointnet2.py:146-181)."""

    def __init__(self, spec, step, dims, c_in, budget: int):
        super().__init__()
        if not step.use_curve_fps:
            raise NotImplementedError("sa-geo without use_curve_fps")
        self.step, self.budget = step, budget
        cx = xyz_width(c_in, step.with_xyz)
        msg_w = 3 if cx is None else cx + 3
        self.conv = _point_conv(spec, step, (msg_w,) + tuple(dims[1:]),
                                act="leaky_relu")

    def forward(self, cloud: Cloud, train: bool = False, bn_momentum=0.1,
                draws=None) -> Cloud:
        step, w = self.step, self.step.curve_window
        cloud = cloud.with_features(cloud.xyz_concat(step.with_xyz))
        idx, idx_valid = sampling.curve_fps(cloud.pos, cloud.curve_id,
                                            cloud.valid, step.curve_fps_arclen,
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


class SAStep(nn.Module):
    """PointNet++ set abstraction (reference pointnet2.py:33-78): voxel or
    FPS downsampling, kNN grouping from the row table, PointNetConv."""

    def __init__(self, spec, step, dims, c_in, budget: int, table_bound):
        super().__init__()
        if step.downsample_type not in ("voxel", "fps"):
            raise NotImplementedError(
                f"sa downsample_type {step.downsample_type!r} is not ported")
        if not step.knn:
            raise NotImplementedError("sa ball grouping is not ported")
        self.step, self.budget, self.table_bound = step, budget, table_bound
        msg_w = 3 if c_in is None else c_in + 3
        self.conv = _point_conv(spec, step, (msg_w,) + tuple(dims[1:]),
                                act="relu")

    def forward(self, cloud: Cloud, tables, train: bool = False,
                bn_momentum=0.1, draws=None) -> Cloud:
        step = self.step
        if step.downsample_type == "voxel":
            idx, idx_valid = sampling.voxel_downsample(
                cloud.pos, cloud.valid, step.voxel_size, self.budget, u=draws)
        else:
            idx, idx_valid = sampling.fps(cloud.pos, cloud.valid, step.ratio,
                                          self.budget, u=draws)
        down = cloud.gather(idx, idx_valid)
        radius = None
        if step.use_fast_knn:
            radius = step.radius if step.radius is not None else 0.25
        nbr_idx, _ = neighbors.subset_knn(
            cloud.pos, cloud.valid, idx, down.valid, step.knn, radius=radius,
            table_bound=self.table_bound, tables=tables)
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


class EdgeConvStep(nn.Module):
    """sgcnn edge convolution, fast message order [x_j, x_i - x_j]
    (reference dgcnn.py:158-207).  Layer 0 re-associates as
    gather(x @ (Wt - Wb)) + x_i @ Wb (+ b), so the (B, N, K, 2C) message
    concat never materializes."""

    def __init__(self, spec, step, dims, c_in, table_bound):
        super().__init__()
        if step.name != "sgcnn" or step.use_sparse_feat_agg:
            raise NotImplementedError(
                f"{step.name} (sparse={step.use_sparse_feat_agg}) is not ported")
        if step.aggr_type != "max":
            raise NotImplementedError(f"sgcnn aggr_type {step.aggr_type!r}")
        self.step, self.table_bound = step, table_bound
        cx = xyz_width(c_in, step.with_xyz)
        self.nn = MLP((2 * cx,) + tuple(dims[1:]), use_bias=spec.use_bias)

    def forward(self, cloud: Cloud, tables, train: bool = False,
                bn_momentum=0.1) -> Cloud:
        step = self.step
        x = cloud.xyz_concat(step.with_xyz)
        r = step.radius if step.radius is not None else 1.0
        nbr_idx, _ = neighbors.same_set_knn(
            cloud.pos, cloud.valid, step.knn, radius=r,
            table_bound=self.table_bound, tables=tables)
        nbr_idx = neighbors.add_self_loops(nbr_idx, cloud.valid)
        lin0 = self.nn.lins[0]
        c = x.shape[-1]
        w_top, w_bot = lin0.weight[:, :c], lin0.weight[:, c:]
        u = x @ (w_top - w_bot).t()
        v = x @ w_bot.t()
        if lin0.bias is not None:
            v = v + lin0.bias
        # the k-major self-row gather: kernels K4 / K4b
        first = (neighbors.gather_neighbors(
            u, nbr_idx.transpose(1, 2).contiguous(), fill=train, layout="kq")
            + v[:, None])
        out = _grouped(first.contiguous(), (nbr_idx >= 0).contiguous(),
                       self.nn, None, "max", train, bn_momentum)
        return cloud.with_features(out * cloud.valid[..., None].to(out.dtype))


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
    3-NN sources are the subset ``parent_idx`` of the skip row."""

    def __init__(self, spec, step, dims, c_in: int, skip_width: int,
                 act: str = "relu"):
        super().__init__()
        self.step = step
        width = c_in + skip_width + (3 if step.with_xyz else 0)
        self.nn = MLP((width,) + tuple(dims[1:]), act=act,
                      use_bias=spec.use_bias)

    def _upsample(self, cloud: Cloud, skip: Cloud, k: int):
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
