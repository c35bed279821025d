"""The step options no shipped config uses, on the port against the JAX
package on the CPU, module by module (the whole model, its launches,
head dropout and the wandb fallback: ``test_torch_port_options_train.py``).

* each option's step module at narrow widths (``__graft_entry__.
  _shrink_feat_dims`` by 8), weights drawn with numpy and carried by
  ``from_jax_variables``, same numpy inputs, in eval and in train
  (``value_and_grad`` under a fixed cotangent): outputs within 1e-4
  abs/rel and sampled rows exact, each parameter's gradient within 2e-3
  of its largest, running statistics 1e-5.  The steps come from
  ``chip_smoke.options_model`` (shapenet-class with phase 19's
  substitutions) and from the nuScenes flagship: mean and weighted-sum
  (sa, sa-geo, slow-order sgcnn), sa random (JAX's ``PRNGKey(0)`` draws
  fed to the port, DEVIATIONS #14), curve-fps with a one-layer MLP,
  sa-geo on FPS, sgcnn attend in the fast order, dgcnn (kNN in feature
  space, max and attend), dgcnn-rad (a 3-D ball on K3 and a 4-D one in
  plain torch), conv1d-fast-v2 with one tap, fp without ``parent_idx``.
  The JAX 3-D searches run on direct differences
  (``torch_port_utils.direct_knn``), as in ``test_torch_port_v1.py``;
* the searches themselves: the feature-space kNN and ball against JAX's
  expanded XLA search, up to distance ties; ``random_downsample`` against
  JAX's on the same draws, index for index;
* head dropout and the wandb fallback: ``test_torch_port_options_train.py``.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.models import modules as jmod
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import neighbors as jnb
from curvecloudnet_tpu.ops import sampling as jsampling
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import modules as tmod
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.ops import neighbors as tnb
from curvecloudnet_tpu_torch.ops import sampling as tsampling
from test_torch_port_eval import random_variables
from test_torch_port_train_model import (_check_grads, _check_stats,
                                         _running_stats)
from test_torch_port_v1 import _clouds, _objects
from torch_port_utils import (assert_same_neighbors, direct_knn,
                              expansion_d2_tol, lidar, load_step)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
MOMENTUM = 0.1


def _specs(name):
    """(jax spec, port spec, object task) at widths / 8; ``options`` is
    shapenet-class with phase 19's substitutions."""
    cfg = load_config(os.path.join(
        REPO, "configs", ("shapenet-class" if name == "options" else name)
        + ".yaml"))
    mc = chip_smoke.options_model(cfg["model"]) if name == "options" \
        else cfg["model"]
    mc = _shrink_feat_dims(mc, 8)
    task = predict.task_of(cfg)
    objects = task in predict.OBJECT_TASKS
    in_dim = predict.OBJECT_IN_DIM if objects else predict.IN_DIM
    return (jparse(mc, in_dim=in_dim, n_out=predict.N_OUT[task]),
            tparse(mc, in_dim=in_dim, n_out=predict.N_OUT[task]), objects)


@pytest.fixture(scope="module")
def specs():
    return {name: _specs(name) for name in ("options", "nuscenes")}


def _variant(spec, i, changes):
    if not changes:
        return spec
    steps = list(spec.steps)
    steps[i] = dataclasses.replace(steps[i], **changes)
    return dataclasses.replace(spec, steps=tuple(steps))


def _cotangent(shape, xp):
    return xp.sin(xp.arange(int(np.prod(shape)), dtype=xp.float32)).reshape(
        shape)


def _random_draws(step, cloud, generator=None):
    """JAX's ``key=None`` draws of a random sa step, ``PRNGKey(0)``'s; the
    deterministic point (None) for every other step (the signature of
    ``CurveCloudNet._draws``, which the whole-model tests replace)."""
    if step.name == "sa" and step.downsample_type == "random":
        return torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.PRNGKey(0), tuple(cloud.valid.shape))))
    return None


# (label, spec, step index, row size, step changes); the options spec's
# steps count the prepended dgcnn-rad
CASES = [
    ("dgcnn-rad 3-D ball (K3)", "options", 0, 512, {}),
    ("dgcnn-rad 4-D ball", "nuscenes", 0, 512,
     dict(name="dgcnn-rad", radius=0.3, feat_dims=(8, 8))),
    ("sa-geo on FPS", "options", 1, 512, {}),
    ("sa-geo weighted-sum", "nuscenes", 1, 1024,
     dict(aggr_type="weighted-sum")),
    ("sa curve-fps, one-layer MLP", "options", 5, 512, {}),
    ("dgcnn max, feature-space kNN", "options", 6, 512, {}),
    ("dgcnn attend, no xyz", "options", 6, 512,
     dict(aggr_type="attend", with_xyz=False)),
    ("sa random", "options", 8, 512, {}),
    ("sgcnn weighted-sum, slow order", "options", 9, 512, {}),
    ("sa mean", "options", 11, 512, {}),
    ("sgcnn attend, fast order", "options", 12, 512, {}),
    ("conv1d-fast-v2, kernel 1", "nuscenes", 0, 512, dict(kernel_size=1)),
]


def _case_inputs(objects, n, c_in, seed):
    if objects:
        pos, cid, valid, _ = _objects(n, seed=seed)
        x = None if c_in is None else np.random.default_rng(seed).normal(
            size=(2, n, c_in)).astype(np.float32)
        return pos, x, cid, valid
    return lidar(n, seed=seed, feat=c_in)


def _modules(specs, name, i, n, changes, seed):
    """The JAX module with numpy-drawn variables, the port's module with
    the same weights, and the same clouds."""
    jspec, tspec, objects = specs[name]
    jspec, tspec = _variant(jspec, i, changes), _variant(tspec, i, changes)
    step, tstep = jspec.steps[i], tspec.steps[i]
    port = TNet(tspec, n, feat_channels=None if objects else 1)
    c_in = port.in_widths[i]
    pos, x, cid, valid = _case_inputs(objects, n, c_in, seed)
    jc, tc = _clouds(pos, x, cid, valid)
    dims = jspec.input_dim(i)
    budget = step.out_budget(n)
    jm = {"conv1d-fast-v2": lambda: jmod.SymmetricCurveConvStep(
              jspec, step, dims),
          "sa-geo": lambda: jmod.CurveSAStep(jspec, step, dims, budget),
          "sa": lambda: jmod.SAStep(jspec, step, dims, budget)}.get(
        step.name, lambda: jmod.EdgeConvStep(jspec, step, dims))()
    variables = random_variables(jm, jc, seed=seed)
    # the port's module at this row's budget (not the model's row there)
    tm = {"conv1d-fast-v2": lambda: tmod.SymmetricCurveConvStep(
              tspec, tstep, c_in),
          "sa-geo": lambda: tmod.CurveSAStep(tspec, tstep, dims, c_in,
                                             budget),
          "sa": lambda: tmod.SAStep(tspec, tstep, dims, c_in, budget, None)
          }.get(step.name, lambda: tmod.EdgeConvStep(tspec, tstep, dims,
                                                     c_in, None))()
    return jm, variables, load_step(tm, variables, step), step, tstep, jc, tc


def _port_call(tm, step, tc, train):
    kw = dict(train=train, bn_momentum=MOMENTUM)
    if step.name in ("sa", "sa-geo"):
        kw["draws"] = _random_draws(step, tc)
    if step.name in ("sa", "sgcnn", "dgcnn", "dgcnn-rad"):
        return tm(tc, None, **kw)
    return tm(tc, **kw)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("label,name,i,n,changes", CASES,
                         ids=[c[0] for c in CASES])
def test_option_module_matches_jax(specs, label, name, i, n, changes, train,
                                   monkeypatch):
    monkeypatch.setattr(jnb, "knn", _direct_3d)
    monkeypatch.setenv("CCN_SPLIT_EDGE", "force")
    jm, variables, tm, step, tstep, jc, tc = _modules(specs, name, i, n,
                                                      changes, seed=i + 3)
    if not train:
        jout = jax.jit(lambda v, c: jm.apply(v, c, train=False))(
            variables, jc)
        with torch.no_grad():
            tout = _port_call(tm, tstep, tc, False)
        _check_out(jout, tout, step)
        return

    def jloss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, jc,
                            train=True, bn_momentum=MOMENTUM,
                            mutable=["batch_stats"])
        r = _cotangent(out.x.shape, jnp)
        return jnp.sum(out.x * r * out.valid[..., None]), (out, mut)

    (_, (jout, mut)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tout = _port_call(tm.train(), tstep, tc, True)
    (tout.x * _cotangent(tout.x.shape, torch) * tout.valid[..., None]
     ).sum().backward()
    _check_out(jout, tout, step)
    sname, prefix = f"step_0_{step.name}", "steps.0."
    one = SimpleNamespace(steps=(step,))
    want = tckpt.from_jax_variables({sname: jg}, {}, one)
    _check_grads(((prefix + k, p) for k, p in tm.named_parameters()), want)
    _check_stats(tm.named_buffers(), _running_stats(
        {sname: jg}, {sname: mut["batch_stats"]}, one, prefix), 1e-5)


def _direct_3d(query, points, q_valid, p_valid, k, radius=None, **kw):
    """JAX's searches on direct differences in 3-D (as the port's K3), its
    own expanded search in feature space (as the port's brute force)."""
    if query.shape[-1] == 3:
        return direct_knn(query, points, q_valid, p_valid, k, radius)
    return _JAX_KNN(query, points, q_valid, p_valid, k, radius=radius, **kw)


_JAX_KNN = jnb.knn


def _check_out(jout, tout, step):
    valid = np.asarray(jout.valid)
    np.testing.assert_array_equal(tout.valid.numpy(), valid)
    if step.is_downsample:
        np.testing.assert_array_equal(tout.parent_idx.numpy(),
                                      np.asarray(jout.parent_idx))
    np.testing.assert_allclose(tout.x.detach().numpy()[valid],
                               np.asarray(jout.x)[valid], **TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fp_without_parent_idx_matches_jax(specs, train):
    """nuScenes' fp step 18 on a cloud with no ``parent_idx``: the 3-NN
    over the whole source row (K3's plain version; JAX's search on direct
    differences)."""
    jspec, tspec, _ = specs["nuscenes"]
    i, n, m = 18, 768, 192
    step = jspec.steps[i]
    port = TNet(tspec, 4096, feat_channels=1)
    c_in, skip_w = port.in_widths[i], port.in_widths[14]
    pos, x, cid, valid = lidar(n, seed=5, feat=skip_w)
    rng = np.random.default_rng(6)
    sub = np.sort(rng.choice(n, m, replace=False))
    src_x = rng.normal(size=(2, m, c_in)).astype(np.float32)
    jsrc, tsrc = _clouds(np.ascontiguousarray(pos[:, sub]), src_x, cid[:, sub],
                         valid[:, sub])
    jskip, tskip = _clouds(pos, x, cid, valid)
    assert jsrc.parent_idx is None and tsrc.parent_idx is None
    jm = jmod.FPStep(jspec, step, jspec.input_dim(i))
    variables = random_variables(jm, jsrc, jskip)
    tm = load_step(tmod.FPStep(tspec, tspec.steps[i], jspec.input_dim(i),
                               c_in, skip_w), variables, step)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnb, "knn", direct_knn)
        if not train:
            jout = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(
                variables, jsrc, jskip)
            with torch.no_grad():
                tout = tm(tsrc, tskip)
            return _check_out(jout, tout, step)

        def jloss(params):
            out, mut = jm.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                jsrc, jskip, train=True,
                                bn_momentum=MOMENTUM,
                                mutable=["batch_stats"])
            r = _cotangent(out.x.shape, jnp)
            return jnp.sum(out.x * r * out.valid[..., None]), (out, mut)

        (_, (jout, mut)), jg = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(variables["params"])
    tout = tm.train()(tsrc, tskip, train=True, bn_momentum=MOMENTUM)
    (tout.x * _cotangent(tout.x.shape, torch) * tout.valid[..., None]
     ).sum().backward()
    _check_out(jout, tout, step)
    sname, prefix = f"step_0_{step.name}", "steps.0."
    one = SimpleNamespace(steps=(step,))
    _check_grads(((prefix + k, p) for k, p in tm.named_parameters()),
                 tckpt.from_jax_variables({sname: jg}, {}, one))
    _check_stats(tm.named_buffers(), _running_stats(
        {sname: jg}, {sname: mut["batch_stats"]}, one, prefix), 1e-5)


# ---------------------------------------------------------------------------
# the searches and the random sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,k,radius", [(19, 30, None), (4, 128, 0.6),
                                          (3, 30, None), (3, 128, 0.2)])
def test_feature_knn_matches_jax(dim, k, radius):
    """dgcnn's graph: the port's feature-space search against JAX's
    ``neighbors.knn`` / ``ball_query`` (expanded on the CPU), as sets up
    to distance ties; a 3-D search is K3's (direct differences)."""
    rng = np.random.default_rng(dim + k)
    n = 400
    x = rng.normal(size=(2, n, dim)).astype(np.float32)
    valid = rng.random((2, n)) > 0.1
    args = tuple(map(jnp.asarray, (x, x, valid, valid)))
    if radius is None:
        ij, _ = jax.jit(jnb.knn, static_argnums=(4,))(*args, k)
    else:
        ij, _ = jax.jit(jnb.ball_query, static_argnums=(4, 5))(*args, radius,
                                                               k)
    it, dt = tnb.feature_knn(torch.from_numpy(x), torch.from_numpy(valid), k,
                             radius)
    assert it.shape == (2, n, k)
    assert_same_neighbors(it.numpy(), np.asarray(ij), x, x, valid,
                          expansion_d2_tol(x, x), radius,
                          capped=radius is not None)
    assert (it.numpy()[~valid] == -1).all()
    if radius is not None:
        assert (dt.numpy()[it.numpy() >= 0] <= np.float32(radius)).all()


@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_random_downsample_matches_jax(ratio):
    """The rank-and-keep of JAX's ``random_downsample`` on its own draws
    (``jax.random.uniform(key, (B, N))``): the same indices."""
    rng = np.random.default_rng(3)
    b, n = 3, 300
    valid = np.arange(n)[None, :] < rng.integers(100, n, size=(b, 1))
    key = jax.random.PRNGKey(7)
    budget = int(np.ceil(n * ratio))
    ji, jv = jsampling.random_downsample(key, jnp.asarray(valid), ratio,
                                         budget=budget)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (b, n))))
    ti, tv = tsampling.random_downsample(torch.from_numpy(valid), ratio,
                                         budget, u=u)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy()[tv.numpy()],
                                  np.asarray(ji)[np.asarray(jv)])
    assert (tv.numpy().sum(1) == np.ceil(valid.sum(1) * ratio)).all()
    # the default draws are a seeded generator's: the same picks each call
    a, _ = tsampling.random_downsample(torch.from_numpy(valid), ratio, budget)
    b_, _ = tsampling.random_downsample(torch.from_numpy(valid), ratio,
                                        budget)
    assert torch.equal(a, b_)
