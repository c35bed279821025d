"""The step-DSL interpreter (counterpart of
``curvecloudnet_tpu/models/base.py``): runs a :class:`ModelSpec`'s steps
over a batch-padded Cloud with the reference's two skip stacks, then the
head MLP.

* downsampled skips: every ``sa``/``sa-geo``/``sa-global`` step pushes its
  input cloud; ``fp``/``fp-geo`` pop and upsample back to it;
* proportional skips: every step named in ``skip_connect_state_store``
  pushes its input features; ``skip-connect`` pops ``num_skips`` of them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import parallel
from ..ops import neighbors
from ..ops.conv1d_train import fused_reduce
from ..ops.neighbors import TABLE_K, TableCache
from .cloud import Cloud
from .layers import MLP
from .modules import (EDGE_ROUTES, EDGE_STEPS, CurveFPStep, CurveSAStep,
                      EdgeConvStep, FPStep, GlobalSAStep, SAStep,
                      SharedMLPStep, SkipConnectStep, SymmetricCurveConvStep,
                      compute_dtype, edge_widths, fused_edge_admits,
                      kernel_grouped)
from .spec import ModelSpec


def _voxel_cell_occupancy(cell: float, v: float) -> int:
    """Exact max count of v-voxels meeting any grid cell of edge ``cell``
    (cubed), both grids anchored at the origin.  Integer rationalization
    (1e-6 quantum) makes the per-axis sweep exact; the pattern repeats
    with period v / gcd, so the sweep is short."""
    ci, vi = round(cell * 1e6), round(v * 1e6)
    g = math.gcd(ci, vi)
    per_axis = 0
    for i in range(vi // g):
        per_axis = max(per_axis,
                       ((i + 1) * ci - 1) // vi - (i * ci) // vi + 1)
    return per_axis ** 3


def row_radius_bounds(spec: ModelSpec):
    """Per step, for the row it searches (the three lists of
    ``curvecloudnet_tpu.models.base._row_radius_bounds``):

    * bounds: the max radius over every 3D same-row table consumer of the
      row, or None when some consumer is unbounded;
    * grid bounds: on a voxel-produced row, the max consumer radius whose
      cell's voxel occupancy fits ``grid_cap(TABLE_K)``, so one grid table
      at that radius serves those consumers; None elsewhere (curve-sampled
      rows have no density bound);
    * grid caps: the cap that occupancy proves for that table (rounded up
      to a multiple of 32, at least 32)."""
    row, next_row = 0, 1
    down_stack, searches, step_row = [], [], []
    row_voxel = {0: None}     # row -> voxel size that produced it
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
            row_voxel[row] = (step.voxel_size if step.name == "sa"
                              and step.downsample_type == "voxel" else None)
        elif step.name in ("fp", "fp-geo"):
            row = down_stack.pop()
    bounds, radii = {}, {}
    for rid, r in searches:
        radii.setdefault(rid, []).append(r)
        if rid in bounds:
            bounds[rid] = (None if bounds[rid] is None or r is None
                           else max(bounds[rid], r))
        else:
            bounds[rid] = r
    grid_bounds, grid_caps = {}, {}
    limit = neighbors.grid_cap(TABLE_K)
    for rid, rs in radii.items():
        v = row_voxel.get(rid)
        eligible = [r for r in rs if r is not None
                    and _voxel_cell_occupancy(r, v) <= limit] if v else []
        if eligible:
            gb = max(eligible)
            proven = _voxel_cell_occupancy(gb, v)
            grid_bounds[rid] = gb
            grid_caps[rid] = max(TABLE_K, -(-proven // 32) * 32)
    return ([bounds.get(r) for r in step_row],
            [grid_bounds.get(r) for r in step_row],
            [grid_caps.get(r) for r in step_row])


def _search_radius(step):
    """The radius of a step's 3D search (None: unbounded)."""
    if step.name == "sgcnn":
        if step.use_sparse_feat_agg:
            return None
        return step.radius if step.radius is not None else 1.0
    if step.use_fast_knn:
        return step.radius if step.radius is not None else 0.25
    return None


def _x_width(spec: ModelSpec, i: int):
    """Width of the features the cloud carries into step i: the declared
    input width less its xyz at step 0 (None: a position-only cloud, as
    the object configs' ``in_dim`` 3), the previous step's output after."""
    if i == 0:
        return spec.in_dim - 3 or None
    return spec.steps[i - 1].feat_dims[-1]


def kernel_launches(spec: ModelSpec, n_points: int, train: bool = False,
                    edge_kernel: str = "group"):
    """Kernel launches of one eval forward, or with ``train`` of one train
    step (forward + backward), any batch size, derived from the spec.

    Eval: K1 once per conv1d-fast-v2 step past one tap (``kernel_size``
    // 2 >= 1), K2 once per
    grouping step that :func:`kernel_grouped` admits (max or attend; in
    train also a dense past layer 0; mean, weighted-sum and a one-layer
    train MLP run in plain torch).  Train: per
    conv step with L layers, K8 runs L forward and L t passes, and a
    standalone reduce for the last layer and for each layer whose successor
    takes an input wider than ``conv1d_train.DW_FUSED`` (the others' sums
    come from their successor's t pass);
    per grouping step with L kernel-side denses (``ops/group_train``), the
    K7 forward runs 2L + 2 launches (the first BN's row statistics, L
    denses, a finalize per BN, the aggregation) and 3 more under attend
    (two denses, a finalize); its backward runs 4 per dense (data
    gradient, weight gradient, a finalize each) and 7 more under attend.
    Both: K4
    once per edge step (sgcnn, dgcnn, dgcnn-rad: its self-row gather; K4b
    once in the backward), K6 once per FPS step (an sa step's ``fps``, an
    sa-geo step without ``use_curve_fps``), K3 once per exact shared row
    table, per fp sweep and per dgcnn search in 3-D (a position-only
    cloud: a wider one is plain torch), K5 (``grid_topk``, listed only
    where it runs) once per distinct
    grid table of a row above ``neighbors.TABLE_MAX_N``; a search no table
    serves launches its own, a ball-grouped sa step (k = 128) one K3.
    conv1d-fast-v1 and sa-global launch nothing.  With
    ``edge_kernel="fused"`` an eval edge step whose widths and aggregation
    ``fused_edge_admits`` launches K9 (``edge_mlp``, listed only where it
    runs) in place of K4 and K2."""
    if edge_kernel not in EDGE_ROUTES:
        raise ValueError(f"edge_kernel {edge_kernel!r}")
    counts = ({"conv1d_train_fwd": 0, "conv1d_train_reduce": 0,
               "conv1d_train_t": 0, "group_train_fwd": 0,
               "group_train_bwd": 0, "gather": 0, "scatter": 0, "knn": 0,
               "fps": 0} if train else
              {"conv1d_chain": 0, "group_reduce": 0, "gather": 0, "knn": 0,
               "fps": 0})
    bounds, grid_bounds, grid_caps = row_radius_bounds(spec)
    sizes, row, down_stack = [n_points], 0, []
    tables = {}      # distinct shared table -> the kernel that builds it
    for i, step in enumerate(spec.steps):
        n = sizes[row]
        if step.name == "conv1d-fast-v2" and (step.kernel_size or 5) // 2:
            if train:
                dims = list(step.feat_dims)
                counts["conv1d_train_fwd"] += len(dims)
                counts["conv1d_train_t"] += len(dims)
                counts["conv1d_train_reduce"] += 1 + sum(
                    not fused_reduce(c) for c in dims[:-1])
            else:
                counts["conv1d_chain"] += 1
        edge = step.name in EDGE_STEPS
        dims, cx = spec.input_dim(i), None
        if edge:     # the widths EdgeConvStep builds
            cx, dims = edge_widths(step, dims, _x_width(spec, i))
        fused = (edge and not train and edge_kernel == "fused"
                 and fused_edge_admits(dims, step.aggr_type))
        if fused:
            counts["edge_mlp"] = counts.get("edge_mlp", 0) + 1
        elif (step.name in ("sa", "sa-geo") or edge) and kernel_grouped(
                step.aggr_type, len(dims) - 1, train):
            if train:
                n_loc = len(dims) - 2
                attend = int(step.aggr_type == "attend")
                counts["group_train_fwd"] += 2 * n_loc + 2 + 3 * attend
                counts["group_train_bwd"] += 4 * n_loc + 7 * attend
            else:
                counts["group_reduce"] += 1
        if edge and not fused:
            counts["gather"] += 1
            if train:
                counts["scatter"] += 1
        if (step.name == "sa" and step.downsample_type == "fps") or (
                step.name == "sa-geo" and not step.use_curve_fps):
            counts["fps"] += 1
        ball = (step.name == "sa" and not step.use_fast_knn
                and step.knn is None)
        if ball or (step.name in ("dgcnn", "dgcnn-rad") and cx == 3):
            counts["knn"] += 1
        elif step.name in ("sa", "sgcnn"):
            radius = _search_radius(step)
            if step.knn <= TABLE_K and n <= neighbors.TABLE_MAX_N:
                tables[(row, bounds[i])] = "knn"
            elif step.knn <= TABLE_K and radius is not None:
                gr, cap = neighbors.grid_table_args(radius, grid_bounds[i],
                                                    grid_caps[i])
                tables[(row, gr, cap)] = neighbors.search_kernel(n, gr, cap)
            else:
                name = neighbors.search_kernel(n, radius)
                counts[name] = counts.get(name, 0) + 1
        if step.name == "fp":
            counts["knn"] += 1
        if step.name in ("sa", "sa-geo", "sa-global"):
            down_stack.append(row)
            sizes.append(step.out_budget(n))
            row = len(sizes) - 1
        elif step.name in ("fp", "fp-geo"):
            row = down_stack.pop()
    for name in tables.values():
        counts[name] = counts.get(name, 0) + 1
    return counts


class CurveCloudNet(nn.Module):
    """The full network: steps (``steps.{i}``) + head MLP (``mlp``).

    ``feat_channels`` is the width of the input cloud's features (None for
    position-only inputs); ``n_points`` is the padded full-resolution row;
    ``edge_kernel`` is the eval route of the sgcnn steps: ``"group"`` (K4 +
    K2) or ``"fused"`` (K9 where the widths admit it, see
    ``modules.fused_edge_admits``).  With ``spec.with_seg_category`` (the
    ShapeNet part-segmentation head) each sample's category goes one-hot
    through ``lin_categorical`` (16 -> 64 -> 64, its biases on even where
    ``use_bias`` is off: reference base.py:60) and is concatenated to
    every point's features before the head.
    """

    CATEGORY_WIDTH = 64

    def __init__(self, spec: ModelSpec, n_points: int, feat_channels=None,
                 edge_kernel: str = "group"):
        super().__init__()
        if spec.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {spec.compute_dtype!r}: float32 "
                             "or bfloat16")
        self.spec = spec
        bounds, grid_bounds, grid_caps = row_radius_bounds(spec)
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
                mod = SAStep(spec, step, dims, w, n_now, bounds[i],
                             grid_bounds[i], grid_caps[i])
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
            elif name in EDGE_STEPS:
                mod = EdgeConvStep(spec, step, dims, w, bounds[i],
                                   grid_bounds[i], grid_caps[i], edge_kernel)
            elif name in ("conv1d-fast-v1", "conv1d-fast-v2"):
                mod = SymmetricCurveConvStep(spec, step, w)
                mod.name = f"step_{i}_{name}"
            elif name == "sa-global":
                n_now = 1
                mod = GlobalSAStep(spec, step, dims, w)
            elif name == "mlp":
                mod = SharedMLPStep(spec, step, dims, w)
            else:
                raise ValueError(f"unknown step {name!r}")
            steps.append(mod)
            if name in ("sa", "sa-geo", "sa-global"):
                down_skips.append(i)
            if name in spec.skip_connect_state_store:
                prop_skips.append(i)
            w = step.feat_dims[-1]
        self.steps = nn.ModuleList(steps)
        self.in_widths = tuple(widths)   # x width of each step's input cloud
        self.lin_categorical = None
        if spec.with_seg_category:
            self.lin_categorical = MLP(
                (spec.n_categories, self.CATEGORY_WIDTH, self.CATEGORY_WIDTH),
                use_bias=True, dtype=compute_dtype(spec))
            w += self.CATEGORY_WIDTH
        self.mlp = None
        if not spec.identity_head:
            self.mlp = MLP((w,) + spec.out_mlp_dims + (spec.n_out,),
                           use_bias=spec.use_bias,
                           dropout=spec.out_mlp_dropout,
                           dtype=compute_dtype(spec))

    @staticmethod
    def _draws(step, cloud: Cloud, generator):
        """A sampling step's uniform draws from ``generator`` (None: the
        deterministic operating point), the shapes of the JAX package's:
        arclength sampling (sa-geo, curve-fps sa) one phase scalar, voxel
        sa one jitter a point, random sa one score a point, FPS (sa, sa-geo
        without ``use_curve_fps``) one start a sample."""
        if generator is None or step.name not in ("sa", "sa-geo"):
            return None
        b, n = cloud.valid.shape
        kind = ("fps" if step.name == "sa-geo" and not step.use_curve_fps
                else "curve-fps" if step.name == "sa-geo"
                else step.downsample_type)
        shape = {"curve-fps": (), "voxel": (b, n), "random": (b, n)}.get(
            kind, (b,))
        # a data-parallel step draws the global batch's and keeps its rows
        return parallel.rand_rows(shape, generator,
                                  generator.device).to(cloud.pos.device)

    def forward(self, cloud: Cloud, categories: torch.Tensor | None = None,
                train: bool = False, bn_momentum=0.1,
                generator: torch.Generator | None = None,
                dropout_masks=None):
        """Returns (logits (B, N, n_out), valid (B, N)); N is 1 after an
        sa-global step.  ``categories`` (B,) int: each sample's object
        category, required by a model with ``with_seg_category``.
        ``train`` runs BatchNorm on masked batch statistics and updates
        the running ones with ``bn_momentum``; the sampling steps draw
        from ``generator`` in step order, then the head's dropout (its
        keep-masks, in order, may be given as ``dropout_masks``).

        With ``compute_dtype: bfloat16`` the model evaluates and trains as
        the JAX package's does (the Linears and the kernels' products in
        bfloat16, the logits bfloat16; parameters, BN statistics and
        gradients float32)."""
        if (categories is None) == (self.lin_categorical is not None):
            raise ValueError("categories are given exactly when the spec "
                             "has with_seg_category")
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
            elif name in EDGE_STEPS:
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
            if name in ("sa", "sa-geo", "sa-global"):
                down_skips.append(i)
            if name in self.spec.skip_connect_state_store:
                prop_skips.append(i)
        x = cloud.x
        if self.lin_categorical is not None:
            onehot = torch.nn.functional.one_hot(
                categories.long(), self.spec.n_categories).to(x.dtype)
            # no mask: in train its BatchNorm takes the B samples' statistics
            cats = self.lin_categorical(onehot[:, None, :], **kw)
            x = torch.cat([x, cats.expand(-1, x.shape[1], -1)], dim=-1)
        if self.mlp is not None:
            x = self.mlp(x, mask=cloud.valid, generator=generator,
                         dropout_masks=dropout_masks, **kw)
        return x, cloud.valid
