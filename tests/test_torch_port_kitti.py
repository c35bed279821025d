"""The narrow KITTI eval forward with grid-served rows: the port against
the JAX package on the CPU.

``configs/kitti.yaml`` with widths divided by 8
(``__graft_entry__._shrink_feat_dims``) on a 64-beam synthetic sweep at
n_pad 4096, B=2.  Both packages' exact-table limit is lowered to 1024
points, so the 2304-point curve-sampled row and the 1152-point
voxel-0.025 row take grid tables, as the 73728 and 36864 rows do at full
size; the JAX package's dispatch takes its accelerator rule for 3D radius
searches (the grid above the limit, except radius >= 0.15 on rows of at
most 40960 points), its grid running its CPU tail.  Checks: weights
carried by ``from_jax_variables``, logits within 2e-3 (the bar of
tests/test_reference_full_model.py), and the spec's launch counts,
``grid_topk`` included.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.data.synthetic import synthetic_lidar_batch
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import neighbors as jnbrs
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
from curvecloudnet_tpu_torch.models import kernel_launches
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.ops import (conv1d_chain, fps, gather, grid_topk,
                                         group_reduce, knn)
from curvecloudnet_tpu_torch.ops import neighbors as tnbrs
from torch_port_utils import jax_init, to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAD = 4096
TABLE_MAX_N = 1024


def _accelerator_rule(dim, radius, n):
    """The JAX package's TPU dispatch for 3D radius searches above its
    exact-table limit (ops/neighbors.py _pick_backend); exact otherwise."""
    if dim == 3 and radius is not None and n > jnbrs.BRUTE_MAX_N and not (
            n <= 40960 and radius >= 0.15):
        return "grid"
    return "xla"


def lower_limits(mp):
    """Both packages' exact-table limit at TABLE_MAX_N, the JAX package's
    dispatch on its accelerator rule (``mp``: a ``pytest.MonkeyPatch``)."""
    mp.setattr(jnbrs, "BRUTE_MAX_N", TABLE_MAX_N)
    mp.setattr(jnbrs, "TABLE_MAX_N", TABLE_MAX_N)
    mp.setattr(jnbrs, "_pick_backend", _accelerator_rule)
    mp.setattr(tnbrs, "TABLE_MAX_N", TABLE_MAX_N)


def narrow_kitti(edge_kernel: str = "group"):
    """Both narrow models with the same weights (the port's on the given
    edge route), the sweep, and the JAX logits; call it under
    :func:`lower_limits`."""
    cfg = load_config(os.path.join(REPO, "configs", "kitti.yaml"))
    mc = _shrink_feat_dims(cfg["model"], 8)
    n_out = predict.N_OUT["kitti"]
    jspec, tspec = jparse(mc, in_dim=4, n_out=n_out), tparse(mc, in_dim=4,
                                                            n_out=n_out)
    pos, x, cid, valid, _ = synthetic_lidar_batch(
        np.random.default_rng(0), 2, N_PAD,
        n_beams=predict.N_BEAMS["kitti"])
    jc = jcloud(*map(jnp.asarray, (pos, cid, valid, x)))
    jm = JNet(jspec, n_points=N_PAD)
    variables = jax_init(jm, jc)
    want, jvalid = jax.jit(lambda v, c: jm.apply(v, c, train=False))(
        variables, jc)
    tm = TNet(tspec, N_PAD, feat_channels=1, edge_kernel=edge_kernel)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    return (tspec, tm.eval(), tcloud(*to_torch(pos, cid, valid, x)),
            np.asarray(want), np.asarray(jvalid))


@pytest.fixture(scope="module")
def kitti():
    """:func:`narrow_kitti` on the group route, under the lowered limits."""
    mp = pytest.MonkeyPatch()
    lower_limits(mp)
    yield narrow_kitti()
    mp.undo()


def test_kitti_logits_match_jax(kitti):
    _, tm, tc, want, valid = kitti
    with torch.no_grad():
        got, tvalid = tm(tc)
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    assert np.isfinite(got.numpy()[valid]).all()
    err = np.abs(got.numpy() - want)[valid]
    assert err.max() <= 2e-3, err.max()


def test_kitti_launch_counts_follow_spec(kitti, monkeypatch):
    """Each kernel wrapper is called as often as kernel_launches derives
    from the spec: two grid tables (one a row), the rest exact."""
    tspec, tm, tc, _, _ = kitti
    seen = {}
    for mod, name, key in [(conv1d_chain, "conv1d_chain_eval", "conv1d_chain"),
                           (group_reduce, "group_reduce", "group_reduce"),
                           (knn, "knn_search", "knn"), (fps, "fps_picks", "fps"),
                           (gather, "gather_km", "gather"),
                           (grid_topk, "grid_topk_records", "grid_topk")]:
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            seen[_key] = seen.get(_key, 0) + 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    with torch.no_grad():
        tm(tc)
    want = kernel_launches(tspec, N_PAD)
    assert seen == want
    assert want["grid_topk"] == 2
