"""K9, the fused edge MLP + masked max, against the JAX package on the CPU,
same numpy inputs:

* its plain version (with the port's BN fold and slow-order fold) against
  ``pallas_edge.fused_edge_mlp_max_single(interpret=True)`` on the gathered
  planes (with JAX's ``fold_batchnorm`` / ``slow_order_transform``), 2 or 3
  layers, fast or slow order, with -1 slots, a query with no live slot and
  an output channel whose live values all lie below -100: 2e-4, the JAX
  test's own bar;
* ``EdgeConvStep`` in eval with ``edge_kernel="fused"`` against the JAX
  module, which on the CPU runs the unsplit composition (gather, concat,
  MLP, masked max): 1e-4;
* which flagship steps the gate admits, and the launch counts of both
  routes;
* the narrow flagship (widths / 8, n_pad 2048, B=2) on the fused route:
  logits within 2e-3 of JAX, each wrapper called as often as
  ``kernel_launches`` derives;
* the narrow KITTI model on the fused route, with the exact-table limit
  lowered so that two rows take grid tables (as
  tests/test_torch_port_kitti.py lowers it): logits within 2e-3 of JAX
  (that file's bar) and within 1e-5 of the port's group route, each
  wrapper called as often as ``kernel_launches`` derives.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
from curvecloudnet_tpu.models import modules as jmod
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import pallas_edge
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
from curvecloudnet_tpu_torch.models import kernel_launches
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.models.layers import MLP
from curvecloudnet_tpu_torch.ops import (conv1d_chain, edge_mlp, fps, gather,
                                         group_reduce, knn)
from curvecloudnet_tpu_torch.ops import grid_topk
from test_torch_port_kitti import N_PAD as KITTI_N_PAD
from test_torch_port_kitti import lower_limits, narrow_kitti
from torch_port_utils import jax_init, lidar, load_step, to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLICE = 2048
FLAGSHIP_FUSED_STEPS = [3, 6, 22, 25, 28]


def _edge_case(n_layers: int, slow: bool):
    rng = np.random.default_rng(10 * n_layers + slow)
    b, n, k, c = 2, 40, 5, 6
    dims = [2 * c] + [8] * (n_layers - 1) + [7]
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    nbr = rng.integers(0, n, size=(b, n, k)).astype(np.int32)
    nbr[:, :, 0] = np.arange(n)            # self loops
    nbr[rng.random((b, n, k)) < 0.3] = -1  # -1 slots
    nbr[0, 3] = -1                         # a query with no live slot
    lins, bns = [], []
    for li in range(n_layers):
        w = (rng.normal(size=(dims[li], dims[li + 1])) * 0.4).astype(np.float32)
        bb = rng.normal(size=dims[li + 1]).astype(np.float32)
        if li == n_layers - 1:
            bb[0] = -500.0                 # every live value below -100
        lins.append((w, bb))
        if li < n_layers - 1:
            bns.append((rng.random(dims[li + 1]).astype(np.float32) + 0.5,
                        rng.normal(size=dims[li + 1]).astype(np.float32),
                        rng.normal(size=dims[li + 1]).astype(np.float32),
                        rng.random(dims[li + 1]).astype(np.float32) + 0.2))
    return x, nbr, dims, lins, bns


@pytest.mark.parametrize("n_layers,slow", [(2, False), (2, True), (3, False)])
def test_plain_matches_pallas_interpret(n_layers, slow):
    x, nbr, dims, lins, bns = _edge_case(n_layers, slow)
    weights, biases = [], []
    for li, (w, bb) in enumerate(lins):
        w_j, b_j = jnp.asarray(w), jnp.asarray(bb)
        if li < n_layers - 1:
            w_j, b_j = pallas_edge.fold_batchnorm(w_j, b_j,
                                                  *map(jnp.asarray, bns[li]))
        if li == 0 and slow:
            w_j = jnp.asarray(pallas_edge.slow_order_transform(x.shape[-1])) @ w_j
        weights.append(w_j)
        biases.append(b_j)
    want = np.stack([np.asarray(pallas_edge.fused_edge_mlp_max_single(
        jnp.asarray(x[bi][np.maximum(nbr[bi], 0)]), jnp.asarray(x[bi]),
        jnp.asarray(nbr[bi] >= 0), tuple(weights), tuple(biases),
        interpret=True)) for bi in range(x.shape[0])])

    mlp = MLP(dims, use_bias=True).eval()
    with torch.no_grad():
        for lin, (w, bb) in zip(mlp.lins, lins):
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(bb))
        for nrm, vals in zip(mlp.norms, bns):
            for t, v in zip((nrm.weight, nrm.bias, nrm.running_mean,
                             nrm.running_var), vals):
                t.copy_(torch.from_numpy(v))
        got = edge_mlp.fused_edge_mlp_max(
            torch.from_numpy(x), torch.from_numpy(nbr),
            *edge_mlp.fold_edge_mlp_eval(mlp, slow=slow)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert (got[0, 3] == -100.0).all()
    masked = (nbr < 0).any(-1)
    assert (got[..., 0][masked] == -100.0).all()
    assert (got[..., 0][~masked] < -100.0).all()


def _specs(shrink: int):
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    mc = _shrink_feat_dims(cfg["model"], shrink) if shrink > 1 else cfg["model"]
    return jparse(mc, in_dim=4, n_out=17), tparse(mc, in_dim=4, n_out=17)


@pytest.fixture(scope="module")
def narrow():
    return _specs(8)


@pytest.mark.parametrize("shrink,i,n", [(8, 3, 768), (8, 22, 512),
                                        (1, 6, 512)])
def test_edge_step_fused_matches_jax(shrink, i, n):
    jspec, tspec = _specs(shrink)
    step = jspec.steps[i]
    port = TNet(tspec, n, feat_channels=1)
    c_in = port.in_widths[i]
    pos, x, cid, valid = lidar(n, seed=i, feat=c_in)
    jc = jcloud(*map(jnp.asarray, (pos, cid, valid, x)))
    tc = tcloud(*to_torch(pos, cid, valid, x))
    dims = jspec.input_dim(i)
    jm = jmod.EdgeConvStep(jspec, step, dims)
    variables = jax_init(jm, jc, seed=i)
    tmod = load_step(type(port.steps[i])(tspec, tspec.steps[i], dims, c_in,
                                         None, edge_kernel="fused"),
                     variables, step)
    assert tmod.fused
    want = jax.jit(lambda v, c: jm.apply(v, c, train=False))(variables, jc)
    with torch.no_grad():
        got = tmod(tc, None)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.x.numpy()[v], np.asarray(want.x)[v],
                               rtol=1e-4, atol=1e-4)


def test_gate_and_launch_counts_of_both_routes():
    """The gate admits the flagship's sgcnn steps with x at most 256 wide
    (steps 3, 6, 22, 25, 28); the others stay on K4 + K2, and train on
    K4/K4b + K7 whatever the route."""
    _, tspec = _specs(1)
    for route, admitted in [("group", []), ("fused", FLAGSHIP_FUSED_STEPS)]:
        model = TNet(tspec, 1024, feat_channels=1, edge_kernel=route)
        assert [i for i, m in enumerate(model.steps)
                if getattr(m, "fused", False)] == admitted
    assert kernel_launches(tspec, 36864, edge_kernel="fused") == {
        "conv1d_chain": 2, "group_reduce": 10, "gather": 5, "knn": 9,
        "fps": 2, "edge_mlp": 5}
    assert kernel_launches(tspec, 36864) == {
        "conv1d_chain": 2, "group_reduce": 15, "gather": 10, "knn": 9,
        "fps": 2}
    assert (kernel_launches(tspec, 36864, train=True, edge_kernel="fused")
            == kernel_launches(tspec, 36864, train=True))
    with pytest.raises(ValueError):
        kernel_launches(tspec, 36864, edge_kernel="split")


@pytest.fixture(scope="module")
def fused_slice(narrow):
    """The narrow flagship on the fused route and in JAX, same weights."""
    jspec, tspec = narrow
    pos, x, cid, valid = lidar(N_SLICE, batch=2, seed=0)
    jc = jcloud(*map(jnp.asarray, (pos, cid, valid, x)))
    tc = tcloud(*to_torch(pos, cid, valid, x))
    jm = JNet(jspec, n_points=N_SLICE)
    variables = jax_init(jm, jc)
    tm = TNet(tspec, N_SLICE, feat_channels=1, edge_kernel="fused")
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    want = jax.jit(lambda v, c: jm.apply(v, c, train=False))(variables, jc)
    return tm.eval(), tc, want


def test_slice_fused_logits_match_jax(fused_slice):
    tm, tc, (want, jvalid) = fused_slice
    with torch.no_grad():
        got, tvalid = tm(tc)
    v = np.asarray(jvalid)
    np.testing.assert_array_equal(tvalid.numpy(), v)
    assert np.isfinite(got.numpy()[v]).all()
    err = np.abs(got.numpy() - np.asarray(want))[v]
    assert err.max() <= 2e-3, err.max()


WRAPPERS = [(conv1d_chain, "conv1d_chain_eval", "conv1d_chain"),
            (group_reduce, "group_reduce", "group_reduce"),
            (knn, "knn_search", "knn"), (fps, "fps_picks", "fps"),
            (gather, "gather_km", "gather"),
            (edge_mlp, "fused_edge_mlp_max", "edge_mlp"),
            (grid_topk, "grid_topk_records", "grid_topk")]


def _counted_forward(mp, tm, tc):
    """The logits of one forward and each wrapper's calls in it."""
    seen = {}
    for mod, name, key in WRAPPERS:
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            seen[_key] = seen.get(_key, 0) + 1
            return _orig(*a, **kw)
        mp.setattr(mod, name, counted)
    with torch.no_grad():
        logits = tm(tc)[0]
    return logits, seen


def test_slice_fused_launch_counts_follow_spec(fused_slice, narrow,
                                               monkeypatch):
    tm, tc, _ = fused_slice
    assert sum(getattr(m, "fused", False) for m in tm.steps) == 10
    _, seen = _counted_forward(monkeypatch, tm, tc)
    want = kernel_launches(narrow[1], N_SLICE, edge_kernel="fused")
    assert {k: v for k, v in want.items() if v} == seen


@pytest.fixture(scope="module")
def kitti_fused():
    """The narrow KITTI model on the fused route (grid rows at the lowered
    limit) and on the group route, same weights: logits, JAX's, the fused
    forward's wrapper calls and the spec's counts, all taken while the
    limit is lowered (it is restored before any other test runs)."""
    mp = pytest.MonkeyPatch()
    try:
        lower_limits(mp)
        tspec, fused, tc, want, jvalid = narrow_kitti("fused")
        group = TNet(tspec, KITTI_N_PAD, feat_channels=1)
        group.load_state_dict(fused.state_dict(), strict=True)
        with torch.no_grad():
            group_logits = group.eval()(tc)[0]
        logits, seen = _counted_forward(mp, fused, tc)
        spec_counts = kernel_launches(tspec, KITTI_N_PAD,
                                      edge_kernel="fused")
        admitted = sum(getattr(m, "fused", False) for m in fused.steps)
    finally:
        mp.undo()
    return dict(logits=logits.numpy(), group=group_logits.numpy(),
                want=want, valid=jvalid, seen=seen, spec=spec_counts,
                admitted=admitted)


def test_kitti_fused_logits_match_jax(kitti_fused):
    r = kitti_fused
    v = r["valid"]
    assert np.isfinite(r["logits"][v]).all()
    err = np.abs(r["logits"] - r["want"])[v]
    assert err.max() <= 2e-3, err.max()


def test_kitti_fused_logits_match_group_route(kitti_fused):
    r = kitti_fused
    err = np.abs(r["logits"] - r["group"])[r["valid"]]
    assert err.max() <= 1e-5, err.max()


def test_kitti_fused_launch_counts_follow_spec(kitti_fused):
    """K9 on every sgcnn step the gate admits, grid rows included (K5 on
    the two grid tables), the rest as the spec derives."""
    r = kitti_fused
    assert r["admitted"] > 0 and r["spec"]["edge_mlp"] == r["admitted"]
    assert r["spec"]["grid_topk"] == 2
    assert {k: v for k, v in r["spec"].items() if v} == r["seen"]
