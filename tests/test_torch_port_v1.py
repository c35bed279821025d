"""The version-1.0 configs (A2D2, ShapeNet part segmentation and
classification, Kortx) on the port against the JAX package on the CPU.

* the new step modules at narrow widths (``__graft_entry__._shrink_feat_dims``
  by 8), weights carried by ``from_jax_variables``, same numpy inputs:
  conv1d-fast-v1, ball-grouped sa (K3 at k = 128, K2 attend over 128
  planes), sgcnn in the slow message order (``use_sparse_feat_agg``) with
  attend (group route) and with max (group and fused routes), sa-global,
  the category head: outputs within 1e-4 abs/rel, sampled rows exact;
  the JAX searches run on direct differences (``torch_port_utils.
  direct_knn``: its CPU search's expanded distances drop points within
  rounding of a ball's radius, which moves that query's output by far
  more than 1e-4; the next item holds that search itself);
* ``neighbors.ball_query`` against JAX's, up to distance ties; K3's plain
  version at k > 32 with a radius against the Pallas kernel in interpret
  mode;
* whole narrow models: logits within 2e-3 (the bar of the JAX package's
  full-model tests) for A2D2 (n_pad 2048, B=2), ShapeNet part
  segmentation with categories and ShapeNet classification (n_pad 1024,
  B=2); launch counts of all four configs against ``kernel_launches``; a
  round trip of each model's weights through JAX
  ``checkpoint.load_torch_checkpoint``; the fused edge route's gate; the
  train forward raising on the branches held here in eval only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu import checkpoint as jckpt
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.data.synthetic import synthetic_object_batch
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
from curvecloudnet_tpu.models import modules as jmod
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import neighbors as jnb
from curvecloudnet_tpu.ops import pallas_knn
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.data import object_batch
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
from curvecloudnet_tpu_torch.models import kernel_launches
from curvecloudnet_tpu_torch.models import modules as tmod
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.ops import (conv1d_chain, edge_mlp, fps, gather,
                                         group_reduce, knn)
from curvecloudnet_tpu_torch.ops import neighbors as tnb
from torch_port_utils import (assert_same_neighbors, direct_knn,
                              expansion_d2_tol, jax_init, lidar, load_step,
                              to_torch)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = 2e-3
CONFIGS = ("audi", "shapenet-seg", "kortx-testsplit", "shapenet-class")


def _cfg(name):
    return load_config(os.path.join(REPO, "configs", f"{name}.yaml"))


def _specs(name, factor=8):
    """(jax spec, port spec, task) of a config, widths / ``factor``."""
    cfg = _cfg(name)
    task = predict.task_of(cfg)
    in_dim = (predict.OBJECT_IN_DIM if task in predict.OBJECT_TASKS
              else predict.IN_DIM)
    mc = _shrink_feat_dims(cfg["model"], factor) if factor else cfg["model"]
    n_out = predict.N_OUT[task]
    return (jparse(mc, in_dim=in_dim, n_out=n_out),
            tparse(mc, in_dim=in_dim, n_out=n_out), task)


@pytest.fixture(scope="module")
def narrow():
    return {name: _specs(name) for name in CONFIGS}


def _objects(n, batch=2, seed=0):
    """Object scans (numpy): pos, curve_id, valid, categories."""
    pos, cid, valid, _, cats = synthetic_object_batch(
        np.random.default_rng(seed), batch, n)
    return pos, cid, valid, cats


def _clouds(pos, x, cid, valid):
    """The same cloud in both packages (``x`` None: positions only)."""
    jx, tx = (None, None) if x is None else (jnp.asarray(x),
                                             torch.from_numpy(x))
    return (jcloud(*map(jnp.asarray, (pos, cid, valid)), jx),
            tcloud(*to_torch(pos, cid, valid), tx))


def _apply(jmodule, variables, *args):
    return jax.jit(lambda v, *a: jmodule.apply(v, *a, train=False))(
        variables, *args)


def _check(jout, tout, rows_exact=False):
    valid = np.asarray(jout.valid)
    np.testing.assert_array_equal(tout.valid.numpy(), valid)
    if rows_exact:
        np.testing.assert_array_equal(tout.pos.numpy(), np.asarray(jout.pos))
        np.testing.assert_array_equal(tout.parent_idx.numpy(),
                                      np.asarray(jout.parent_idx))
    np.testing.assert_allclose(tout.x.numpy()[valid],
                               np.asarray(jout.x)[valid], **TOL)


# (config, step index, row size, edge route): the new modules
MODULE_CASES = [
    ("audi", 2, 1024, "group"),            # conv1d-fast-v1
    ("audi", 4, 1024, "group"),            # ball sa, attend
    ("audi", 5, 768, "group"),             # slow-order sgcnn, attend
    ("shapenet-seg", 4, 1024, "group"),    # ball sa on object scans
    ("shapenet-seg", 5, 1024, "group"),    # slow-order sgcnn, max
    ("shapenet-seg", 5, 1024, "fused"),    # the same on K9's slow fold
    ("kortx-testsplit", 2, 1024, "group"),  # conv1d-fast-v1, kernel 7
    ("shapenet-class", 14, 256, "group"),  # sa-global
]


@pytest.mark.parametrize("name,i,n,route", MODULE_CASES)
def test_step_module_matches_jax(narrow, name, i, n, route, monkeypatch):
    monkeypatch.setattr(jnb, "knn", direct_knn)
    jspec, tspec, task = narrow[name]
    step, tstep = jspec.steps[i], tspec.steps[i]
    objects = task in predict.OBJECT_TASKS
    port = TNet(tspec, n, feat_channels=None if objects else 1)
    c_in = port.in_widths[i]
    if objects:
        pos, cid, valid, _ = _objects(n, seed=i)
        x = None if c_in is None else np.random.default_rng(i).normal(
            size=(2, n, c_in)).astype(np.float32)
    else:
        pos, x, cid, valid = lidar(n, seed=i, feat=c_in)
    jc, tc = _clouds(pos, x, cid, valid)
    dims = jspec.input_dim(i)
    budget = step.out_budget(n)
    jm = {"conv1d-fast-v1": lambda: jmod.SymmetricCurveConvStep(
              jspec, step, dims, v1=True),
          "sgcnn": lambda: jmod.EdgeConvStep(jspec, step, dims),
          "sa": lambda: jmod.SAStep(jspec, step, dims, budget),
          "sa-global": lambda: jmod.GlobalSAStep(jspec, step, dims),
          }[step.name]()
    variables = jax_init(jm, jc, seed=i)
    args = {"conv1d-fast-v1": (tspec, tstep, c_in),
            "sgcnn": (tspec, tstep, dims, c_in, None, None, None, route),
            "sa": (tspec, tstep, dims, c_in, budget, None),
            "sa-global": (tspec, tstep, dims, c_in)}[step.name]
    tm = load_step(type(port.steps[i])(*args), variables, step)
    if route == "fused":
        assert tm.fused and tm.slow
    with torch.no_grad():
        tout = tm(tc, None) if step.name in ("sa", "sgcnn") else tm(tc)
    _check(_apply(jm, variables, jc), tout, rows_exact=step.name == "sa")


def test_category_head_matches_jax(narrow):
    """The lin_categorical head: the ShapeNet part-segmentation model cut
    to its mlp step, categories one-hot through (16, 64, 64), broadcast over
    the points and concatenated before the head."""
    import dataclasses

    jspec, tspec, _ = narrow["shapenet-seg"]
    jspec = dataclasses.replace(jspec, steps=jspec.steps[1:2])
    tspec = dataclasses.replace(tspec, steps=tspec.steps[1:2])
    n = 256
    pos, cid, valid, cats = _objects(n, seed=3)
    jc, tc = _clouds(pos, None, cid, valid)
    jm = JNet(jspec, n_points=n)
    variables = jax_init(jm, jc, jnp.asarray(cats), seed=3)
    assert "lin_categorical" in variables["params"]
    tm = TNet(tspec, n)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    assert tm.lin_categorical.lins[0].bias is not None
    want, _ = _apply(jm, variables, jc, jnp.asarray(cats))
    with torch.no_grad():
        got, _ = tm.eval()(tc, torch.from_numpy(cats))
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **TOL)
    with pytest.raises(ValueError):
        tm(tc)


@pytest.mark.parametrize("radius,k", [(0.03, 128), (0.15, 128), (0.3, 64)])
def test_ball_query_matches_jax(radius, k):
    pos, _, _, valid = lidar(1536, seed=4)
    sub = np.sort(np.random.default_rng(5).choice(1536, 400, replace=False))
    q = np.ascontiguousarray(pos[:, sub])
    qv = valid[:, sub]
    ij, dj = jax.jit(jnb.ball_query, static_argnums=(4, 5))(
        *map(jnp.asarray, (q, pos, qv, valid)), radius, k)
    it, dt = tnb.ball_query(*to_torch(q, pos, qv, valid), radius, k)
    assert it.shape == (2, 400, k)
    assert_same_neighbors(it.numpy(), np.asarray(ij), q, pos, qv,
                          expansion_d2_tol(q, pos), radius, capped=True)
    live = (it.numpy() >= 0) & (np.asarray(ij) >= 0)
    np.testing.assert_allclose(dt.numpy()[live], np.asarray(dj)[live],
                               rtol=1e-3, atol=1e-3)
    assert (dt.numpy()[it.numpy() >= 0] <= np.float32(radius)).all()


@pytest.mark.parametrize("k,radius", [(33, 0.9), (64, 0.6), (128, 0.8),
                                      (128, None)])
def test_knn_plain_k_above_32_matches_pallas(k, radius):
    rng = np.random.default_rng(k)
    q_n, n = 200, 600
    query = rng.normal(size=(2, q_n, 3)).astype(np.float32)
    points = rng.normal(size=(2, n, 3)).astype(np.float32)
    qv = rng.random((2, q_n)) > 0.1
    pv = rng.random((2, n)) > 0.1
    idx_p, dist_p = pallas_knn.knn_pallas(
        *map(jnp.asarray, (query, points, qv, pv)), k, radius=radius,
        interpret=True)
    idx_t, dist_t = knn.knn_search(
        *map(torch.from_numpy, (query, points, qv, pv)), k, radius)
    d_p, d_t = np.asarray(dist_p), dist_t.numpy()
    live = d_t < 1e20
    np.testing.assert_allclose(d_t[live], d_p[live], rtol=1e-3, atol=1e-6)
    # quantized Pallas distances: ties within 2^-12 of the boundary d2
    d2_tol = 2.0 ** -12 * float(np.max(np.where(live, d_t, 0.0)) ** 2) + 1e-9
    assert_same_neighbors(idx_t.numpy(), idx_p, query, points, qv, d2_tol,
                          radius, capped=True)
    assert (idx_t.numpy()[~qv] == -1).all()


# config -> (row size, batch)
SLICES = {"audi": (2048, 2), "shapenet-seg": (1024, 2),
          "shapenet-class": (1024, 2)}


def _inputs(n, batch, task):
    if task in predict.OBJECT_TASKS:
        pos, cid, valid, cats = _objects(n, batch)
        return pos, None, cid, valid, cats
    pos, x, cid, valid = lidar(n, batch=batch, seed=0)
    return pos, x, cid, valid, None


@pytest.fixture(scope="module")
def slices(narrow):
    """Each narrow slice model in both packages, same (perturbed) weights,
    and its inputs."""
    out = {}
    for name, (n, batch) in SLICES.items():
        jspec, tspec, task = narrow[name]
        pos, x, cid, valid, cats = _inputs(n, batch, task)
        jc, tc = _clouds(pos, x, cid, valid)
        jcats = tcats = None
        if jspec.with_seg_category:
            jcats, tcats = jnp.asarray(cats), torch.from_numpy(cats)
        jm = JNet(jspec, n_points=n)
        variables = jax_init(jm, jc, jcats)
        sd = tckpt.from_jax_variables(variables["params"],
                                      variables["batch_stats"], jspec)
        models = {}
        for route in ("group", "fused"):
            tm = TNet(tspec, n, feat_channels=None if x is None else 1,
                      edge_kernel=route)
            tm.load_state_dict(sd, strict=True)
            models[route] = tm.eval()
        out[name] = (jm, variables, models, (jc, jcats), (tc, tcats))
    return out


@pytest.mark.parametrize("name", list(SLICES))
def test_slice_logits_match_jax(slices, name, monkeypatch):
    monkeypatch.setattr(jnb, "knn", direct_knn)
    jm, variables, models, (jc, jcats), (tc, tcats) = slices[name]
    want, jvalid = _apply(jm, variables, jc, jcats)
    valid = np.asarray(jvalid)
    with torch.no_grad():
        got, tvalid = models["group"](tc, tcats)
        fused, _ = models["fused"](tc, tcats)
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    assert got.shape == want.shape
    assert np.isfinite(got.numpy()[valid]).all()
    err = np.abs(got.numpy() - np.asarray(want))[valid]
    assert err.max() <= LOGIT_TOL, err.max()
    # the fused route (K9's slow fold on the admitted max steps) against
    # the group route
    np.testing.assert_allclose(fused.numpy()[valid], got.numpy()[valid],
                               rtol=1e-5, atol=1e-5)


def _counted(monkeypatch):
    seen = {}
    for mod, name, key in [(conv1d_chain, "conv1d_chain_eval", "conv1d_chain"),
                           (group_reduce, "group_reduce", "group_reduce"),
                           (knn, "knn_search", "knn"), (fps, "fps_picks", "fps"),
                           (gather, "gather_km", "gather"),
                           (edge_mlp, "fused_edge_mlp_max", "edge_mlp")]:
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            seen[_key] = seen.get(_key, 0) + 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return seen


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("route", ["group", "fused"])
def test_launch_counts_follow_spec(narrow, name, route, monkeypatch):
    """One forward of each narrow model calls each kernel wrapper as often
    as kernel_launches derives from the spec (on the CPU the wrappers run
    the plain versions; the count is taken at the wrapper boundary)."""
    _, tspec, task = narrow[name]
    n = 1024
    pos, x, cid, valid, cats = _inputs(n, 2, task)
    if not tspec.with_seg_category:
        cats = None
    tm = TNet(tspec, n, feat_channels=None if x is None else 1,
              edge_kernel=route)
    predict.init_weights(tm, torch.Generator().manual_seed(0))
    seen = _counted(monkeypatch)
    with torch.no_grad():
        tm.eval()(_clouds(pos, x, cid, valid)[1],
                  None if cats is None else torch.from_numpy(cats))
    want = {k: v for k, v in kernel_launches(tspec, n, edge_kernel=route)
            .items() if v}
    assert seen == want


# the full-size launches a forward (nothing depends on the batch)
FULL_LAUNCHES = {
    ("audi", "group"): {"group_reduce": 10, "gather": 6, "knn": 9, "fps": 3},
    ("shapenet-seg", "fused"): {"group_reduce": 7, "gather": 3, "knn": 9,
                                "fps": 3, "edge_mlp": 3},
    ("kortx-testsplit", "group"): {"group_reduce": 10, "gather": 6,
                                   "knn": 9, "fps": 3},
    ("shapenet-class", "fused"): {"group_reduce": 7, "gather": 3, "knn": 6,
                                  "fps": 3, "edge_mlp": 1},
}


@pytest.mark.parametrize("name,route", list(FULL_LAUNCHES))
def test_full_size_launch_counts(name, route):
    """At the published widths: each ball sa step one K3 call (k = 128),
    each slow-order sgcnn row one exact table, no K1 (conv1d-fast-v1 is
    plain torch), K9 on the max steps at most 512 wide."""
    _, tspec, task = _specs(name, factor=None)
    n = predict.n_pad_of(os.path.join(REPO, "configs", f"{name}.yaml"))
    got = {k: v for k, v in kernel_launches(tspec, n, edge_kernel=route)
           .items() if v}
    assert got == FULL_LAUNCHES[(name, route)]


@pytest.mark.parametrize("name", CONFIGS)
def test_checkpoint_round_trip(narrow, name):
    """port state_dict -> JAX load_torch_checkpoint gives the JAX model's
    trees key for key, shape for shape; from_jax_variables inverts it."""
    jspec, tspec, task = narrow[name]
    n = 1024
    pos, x, cid, valid, cats = _inputs(n, 2, task)
    jc, _ = _clouds(pos, x, cid, valid)
    jm, key = JNet(jspec, n_points=n), jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jc,
        jnp.asarray(cats) if jspec.with_seg_category else None, train=False))
    port = TNet(tspec, n, feat_channels=None if x is None else 1)
    predict.init_weights(port, torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = jckpt.load_torch_checkpoint(sd, jspec)

    def flat(tree):
        return {jax.tree_util.keystr(k): np.shape(v) for k, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat((params, stats)) == flat((variables["params"],
                                          variables["batch_stats"]))
    back = tckpt.from_jax_variables(params, stats, jspec)
    assert back.keys() == port.state_dict().keys()
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


def test_fused_gate_follows_jax():
    """JAX's _try_fused takes max aggregation only (modules.py:715): an
    attend step stays on the group route however narrow."""
    assert tmod.fused_edge_admits((16, 8, 8), "max")
    assert not tmod.fused_edge_admits((16, 8, 8), "attend")
    assert not tmod.fused_edge_admits((518, 256, 256), "max")
    _, tspec, _ = _specs("audi", factor=None)
    model = TNet(tspec, 2048, feat_channels=1, edge_kernel="fused")
    sgcnn = [m for m in model.steps if isinstance(m, tmod.EdgeConvStep)]
    assert sgcnn and not any(m.fused for m in sgcnn)


@pytest.mark.parametrize("name,i", [("audi", 2), ("audi", 4), ("audi", 5),
                                    ("shapenet-class", 14)])
def test_train_raises_on_eval_only_branches(narrow, name, i):
    _, tspec, task = narrow[name]
    n = 256
    port = TNet(tspec, n, feat_channels=None if task in predict.OBJECT_TASKS
                else 1)
    pos, x, cid, valid = lidar(n, seed=1, feat=port.in_widths[i])
    tc = tcloud(*to_torch(pos, cid, valid, x))
    mod = port.steps[i]
    with pytest.raises(NotImplementedError, match="in train"):
        mod(tc, None, train=True) if tspec.steps[i].name in (
            "sa", "sgcnn") else mod(tc, train=True)
    with pytest.raises(NotImplementedError):
        kernel_launches(tspec, n, train=True)


def test_object_scans_match_jax():
    want = synthetic_object_batch(np.random.default_rng(7), 3, 1024)
    got = object_batch(np.random.default_rng(7), 3, 1024)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
