"""Typed step specifications — the architecture DSL schema.

A copy of ``curvecloudnet_tpu/models/spec.py`` (pure Python): importing the
JAX package's ``models`` pulls in flax, so the port keeps its own copy.
``tests/test_torch_port_ops.py`` checks that both parse every config to
equal specs.

The reference declares architectures as config data: a ``steps`` list plus
parallel per-step lists ``feat_dims / knn / ratios / radii / num_skips /
kernel_sizes`` interpreted by ``ModelBase`` (reference ``src/models/base.py:
18-129``).  Here the same YAML schema parses into frozen dataclasses so the
model definition is a hashable static argument to jit/pjit.

TPU-specific addition: every *downsampling* step carries a static output
``budget`` (padded slot count).  The reference lets tensors shrink dynamically
(data-dependent shapes); under XLA each stage instead gathers into a
fixed-size row with a validity mask.  ``budget_ratio`` defaults come from the
step's own ``ratio`` when it has one, else a conservative constant that the
per-dataset configs override.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

STEP_NAMES = (
    "sa",
    "sa-global",
    "sa-geo",
    "fp",
    "fp-geo",
    "dgcnn",
    "dgcnn-rad",
    "sgcnn",
    "conv1d-fast-v1",
    "conv1d-fast-v2",
    "skip-connect",
    "mlp",
)

DOWNSAMPLE_TYPES = ("random", "fps", "curve-fps", "voxel")
AGGR_TYPES = ("max", "mean", "attend", "weighted-sum")

# Default padded-budget fraction for steps whose kept-count is data dependent
# (voxel hashing, arclength-uniform curve sampling).  Overridable per step via
# the ``budget_ratio`` config key.
DEFAULT_BUDGET_RATIO = 0.5


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """One entry of the ``steps`` list, merged with its parallel-list values."""

    name: str
    feat_dims: Tuple[int, ...]
    # parallel-list values (reference base.py:86-129)
    knn: Optional[int] = None
    ratio: Optional[float] = None
    radius: Optional[float] = None
    num_skips: Optional[int] = None
    kernel_size: Optional[int] = None
    # per-step dict overrides (reference base.py:39-44)
    with_xyz: bool = False
    with_diff: bool = False
    aggr_type: str = "max"
    downsample_type: str = "random"
    curve_fps_arclen: Optional[float] = None
    use_curve_fps: bool = False
    voxel_size: Optional[float] = None
    normalize_radius: bool = False
    use_fast_knn: bool = True
    use_sparse_feat_agg: bool = False
    plain_last: bool = True
    pooling: str = "max"
    act: Optional[str] = None
    # TPU-native static output budget (fraction of the step's input row size)
    budget_ratio: Optional[float] = None
    # static half-window for geodesic (along-curve) grouping; the reference
    # sizes its window dynamically per curve (point_ops.py:165-167), so this
    # caps the per-point neighbor count at 2*curve_window+1 candidates
    curve_window: int = 32

    def __post_init__(self):
        if self.name not in STEP_NAMES:
            raise ValueError(f"unknown step {self.name!r}")
        if self.aggr_type not in AGGR_TYPES:
            raise ValueError(f"unknown aggr_type {self.aggr_type!r}")
        if self.downsample_type not in DOWNSAMPLE_TYPES:
            raise ValueError(f"unknown downsample_type {self.downsample_type!r}")

    @property
    def is_downsample(self) -> bool:
        return self.name in ("sa", "sa-geo", "sa-global")

    @property
    def is_upsample(self) -> bool:
        return self.name in ("fp", "fp-geo")

    def out_budget(self, n_in: int) -> int:
        """Static padded row size this step emits given input row size."""
        if self.name == "sa-global":
            return 1
        if not self.is_downsample:
            return n_in
        if self.name == "sa" and self.downsample_type in ("random", "fps"):
            frac = self.budget_ratio if self.budget_ratio is not None else self.ratio
            return max(1, math.ceil(n_in * frac))
        if self.name == "sa-geo" and not self.use_curve_fps:
            frac = self.budget_ratio if self.budget_ratio is not None else self.ratio
            return max(1, math.ceil(n_in * frac))
        frac = self.budget_ratio if self.budget_ratio is not None else DEFAULT_BUDGET_RATIO
        return max(1, math.ceil(n_in * frac))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Full model: step sequence + head (reference ModelBase signature)."""

    in_dim: int
    n_out: int
    steps: Tuple[StepSpec, ...]
    out_mlp_dims: Tuple[int, ...]
    out_mlp_dropout: float = 0.5
    with_seg_category: bool = False
    n_categories: int = 16
    use_bias: bool = False
    version: float = 2.0
    skip_connect_state_store: Tuple[str, ...] = ()
    identity_head: bool = False
    # "float32" or "bfloat16" in the JAX package (its matmul compute dtype);
    # the port computes in float32 only and CurveCloudNet raises on bfloat16
    compute_dtype: str = "float32"
    # static per-row curve-count budget for the conv1d-fast-v2 gap layout
    # (reference fast_conv1d.py:49-74 zero-stuffs every curve boundary);
    # rows with more curves lose gaps between the excess (telemetry counts)
    curve_budget: int = 2048

    def input_dim(self, i: int) -> Tuple[int, ...]:
        """Per-step MLP dims incl. inferred input width (base.py:66-84)."""
        step = self.steps[i]
        name, with_xyz = step.name, step.with_xyz
        if i == 0:
            if name in ("dgcnn", "sgcnn"):
                input_dim = [self.in_dim * 2]
            elif name in ("sa", "sa-global", "sa-geo"):
                input_dim = [self.in_dim + 3 * with_xyz]
            else:
                input_dim = [self.in_dim]
        else:
            prev = self.steps[i - 1].feat_dims[-1]
            if name in ("sa", "sa-global", "sa-geo"):
                input_dim = [prev + 3 + 3 * with_xyz]
            elif name in ("dgcnn", "sgcnn"):
                input_dim = [2 * (prev + 3 * with_xyz)]
            elif name in ("skip-connect", "fp", "fp-geo"):
                input_dim = []
            elif name in ("mlp", "conv1d-fast-v1", "conv1d-fast-v2"):
                input_dim = [prev + 3 * with_xyz]
            else:
                raise NotImplementedError(name)
        return tuple(input_dim) + step.feat_dims


_PARALLEL_KEYS = {
    "knn": "knn",
    "ratios": "ratio",
    "radii": "radius",
    "num_skips": "num_skips",
    "kernel_sizes": "kernel_size",
}

_STEP_OVERRIDE_KEYS = (
    "with_xyz", "with_diff", "aggr_type", "downsample_type",
    "curve_fps_arclen", "use_curve_fps", "voxel_size", "normalize_radius",
    "use_fast_knn", "use_sparse_feat_agg", "plain_last", "pooling", "act",
    "budget_ratio", "curve_window",
)


def parse_model_config(model_cfg: dict, in_dim: int, n_out: int) -> ModelSpec:
    """Parse the reference's YAML ``model:`` block into a ModelSpec.

    Mirrors ModelBase.__init__ (reference base.py:28-64): ``steps`` entries
    are either bare names or dicts with ``step_name`` + overrides; parallel
    lists supply knn/ratio/radius/num_skips/kernel_size per index.
    """
    raw_steps = model_cfg["steps"]
    n = len(raw_steps)
    # Native (inline) schema: each step dict carries its own feat_dims /
    # knn / ratio / radius / num_skips / kernel_size.  Reference schema:
    # parallel top-level lists indexed by step position.
    feat_dims = model_cfg.get("feat_dims")
    parallel = {
        field: (model_cfg.get(key) or [None] * n)
        for key, field in _PARALLEL_KEYS.items()
    }

    steps = []
    for i, entry in enumerate(raw_steps):
        kwargs = {}
        step_feat_dims = None
        if isinstance(entry, dict):
            entry = dict(entry)
            name = entry.pop("step_name")
            step_feat_dims = entry.pop("feat_dims", None)
            for field in _PARALLEL_KEYS.values():
                if field in entry:
                    kwargs[field] = entry.pop(field)
            for k, v in entry.items():
                if k in _STEP_OVERRIDE_KEYS:
                    kwargs[k] = v
        else:
            name = entry
        if step_feat_dims is None:
            step_feat_dims = feat_dims[i]
        # global per-model flags that the reference forwards to every step
        for k in _STEP_OVERRIDE_KEYS:
            if k in model_cfg and k not in kwargs and k not in (
                    "with_xyz", "with_diff"):
                kwargs[k] = model_cfg[k]
        for field in _PARALLEL_KEYS.values():
            val = parallel[field][i] if i < len(parallel[field]) else None
            if val is not None and field not in kwargs:
                kwargs[field] = val
        steps.append(StepSpec(
            name=name,
            feat_dims=tuple(step_feat_dims),
            **kwargs,
        ))

    out_mlp = model_cfg.get("out_mlp", {})
    if isinstance(out_mlp, dict):
        out_mlp = dict(out_mlp)
        out_dims = tuple(out_mlp.pop("dims", ()))
        dropout = out_mlp.get("dropout", 0.5)
        with_cat = bool(out_mlp.get("with_seg_category", False))
        identity = bool(out_mlp.get("identity", False))
    else:
        out_dims = tuple(out_mlp)
        dropout, with_cat, identity = 0.5, False, False

    return ModelSpec(
        in_dim=in_dim,
        n_out=n_out,
        steps=tuple(steps),
        out_mlp_dims=out_dims,
        out_mlp_dropout=dropout,
        with_seg_category=with_cat,
        use_bias=bool(model_cfg.get("use_bias", False)),
        version=float(model_cfg.get("version", 2.0)),
        skip_connect_state_store=tuple(
            model_cfg.get("skip_connect_state_store", ())
        ),
        identity_head=identity,
        curve_budget=int(model_cfg.get("curve_budget", 2048)),
        compute_dtype=model_cfg.get("compute_dtype", "float32"),
    )
