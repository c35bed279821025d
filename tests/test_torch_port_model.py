"""The port's step modules and whole network against the JAX package on
the CPU, its weight bridge, its launch counts, and that it imports no JAX.

* every step module of the flagship path against the JAX module, same
  weights (carried by ``from_jax_variables``), same numpy inputs: outputs
  within 1e-4 abs/rel, sampled rows exact;
* the slice: the whole 33-step nuScenes flagship with widths divided by 8
  (``__graft_entry__._shrink_feat_dims``) at n_pad 2048, B=2: logits
  within 2e-3 max abs, the bar of tests/test_reference_full_model.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu import checkpoint as jckpt
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
from curvecloudnet_tpu.models import modules as jmod
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import sampling as jsmp
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
from curvecloudnet_tpu_torch.models import kernel_launches
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.ops import (conv1d_chain, fps, gather,
                                         group_reduce, knn)
from torch_port_utils import jax_init, lidar, load_step, to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
N_SLICE = 2048


@pytest.fixture(scope="module")
def narrow():
    """The flagship config with widths / 8, parsed by both packages."""
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    mc = _shrink_feat_dims(cfg["model"], 8)
    return jparse(mc, in_dim=4, n_out=17), tparse(mc, in_dim=4, n_out=17)


def _clouds(pos, x, cid, valid):
    return (jcloud(*map(jnp.asarray, (pos, cid, valid, x))),
            tcloud(*to_torch(pos, cid, valid, x)))


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


# step index in the flagship -> row size the module test runs at
SINGLE_STEPS = [(0, 768), (1, 768), (2, 512), (3, 768), (5, 1024),
                (11, 1024), (14, 512), (31, 768)]


@pytest.mark.parametrize("i,n", SINGLE_STEPS)
def test_step_module_matches_jax(narrow, i, n):
    jspec, tspec = narrow
    step, tstep = jspec.steps[i], tspec.steps[i]
    port = TNet(tspec, n, feat_channels=1)
    c_in = port.in_widths[i]
    pos, x, cid, valid = lidar(n, seed=i, feat=c_in)
    jc, tc = _clouds(pos, x, cid, valid)
    dims = jspec.input_dim(i)
    budget = step.out_budget(n)
    jm = {"conv1d-fast-v2": lambda: jmod.SymmetricCurveConvStep(jspec, step, dims),
          "sa-geo": lambda: jmod.CurveSAStep(jspec, step, dims, budget),
          "mlp": lambda: jmod.SharedMLPStep(jspec, step, dims),
          "sgcnn": lambda: jmod.EdgeConvStep(jspec, step, dims),
          "sa": lambda: jmod.SAStep(jspec, step, dims, budget)}[step.name]()
    variables = jax_init(jm, jc, seed=i)
    # rebuild the port's module at this row size (budgets follow n)
    tm = type(port.steps[i])
    args = {"conv1d-fast-v2": (tspec, tstep, c_in),
            "sa-geo": (tspec, tstep, dims, c_in, budget),
            "mlp": (tspec, tstep, dims, c_in),
            "sgcnn": (tspec, tstep, dims, c_in, None),
            "sa": (tspec, tstep, dims, c_in, budget, None)}[step.name]
    tmod = load_step(tm(*args), variables, step)
    with torch.no_grad():
        tout = tmod(tc, None) if step.name in ("sa", "sgcnn") else tmod(tc)
    _check(_apply(jm, variables, jc), tout,
           rows_exact=step.name in ("sa", "sa-geo"))


def _direct_knn(query, points, q_valid, p_valid, k, radius=None, **_):
    """An exact JAX kNN on direct differences (the JAX CPU search expands
    |q|^2 + |p|^2 - 2 q.p, whose rounding moves the fp step's inverse-d^2
    weights by up to eps |p|^2 / d^2; tests/test_torch_port_ops.py holds
    the interpolation against the real JAX search within that bound)."""
    d2 = jnp.sum((query[:, :, None, :] - points[:, None, :, :]) ** 2, -1)
    d2 = jnp.where(p_valid[:, None, :], d2, 1e30)
    neg, idx = jax.lax.top_k(-d2, min(k, points.shape[1]))
    good = (-neg < 1e30) & q_valid[:, :, None]
    if radius is not None:
        good = good & (-neg <= radius * radius)
    return (jnp.where(good, idx, -1).astype(jnp.int32),
            jnp.where(good, jnp.sqrt(-neg), 1e30))


@pytest.mark.parametrize("i", [4, 18, 30])
def test_skip_and_fp_modules_match_jax(narrow, i, monkeypatch):
    """skip-connect (step 4), fp (18: voxel-kept sources, the JAX fp search
    run on direct differences), fp-geo (30: curve-sampled sources)."""
    from curvecloudnet_tpu.ops import interpolate as jint

    monkeypatch.setattr(jint.nbr_ops, "knn", _direct_knn)
    jspec, tspec = narrow
    step, tstep = jspec.steps[i], tspec.steps[i]
    n = 768
    port = TNet(tspec, n, feat_channels=1)
    c_in, dims = port.in_widths[i], jspec.input_dim(i)
    rng = np.random.default_rng(i)
    pos, _, cid, valid = lidar(n, seed=i)
    if step.name == "skip-connect":
        x = rng.normal(size=(2, n, c_in)).astype(np.float32)
        skip = rng.normal(size=(2, n, port.in_widths[3])).astype(np.float32)
        jc, tc = _clouds(pos, x, cid, valid)
        jm = jmod.SkipConnectStep(jspec, step, dims)
        variables = jax_init(jm, jc, [jnp.asarray(skip)])
        tmod = load_step(type(port.steps[i])(tspec, tstep, dims, c_in,
                                              [skip.shape[-1]]),
                         variables, step)
        with torch.no_grad():
            tout = tmod(tc, [torch.from_numpy(skip)])
        _check(_apply(jm, variables, jc, [jnp.asarray(skip)]), tout)
        return
    skip_w = port.steps[i].nn.lins[0].in_features - c_in - 3
    xs = rng.normal(size=(2, n, skip_w)).astype(np.float32)
    jskip, tskip = _clouds(pos, xs, cid, valid)
    jp, jv = jnp.asarray(pos), jnp.asarray(valid)
    if step.name == "fp":
        idx, iv = jax.jit(jsmp.voxel_downsample, static_argnums=(2, 3))(
            jp, jv, 0.03, n // 2)
    else:
        idx, iv = jax.jit(jsmp.curve_fps, static_argnums=(3, 4))(
            jp, jnp.asarray(cid), jv, 0.007, n // 2)
    idx, iv = np.asarray(idx), np.asarray(iv)
    xd = rng.normal(size=(2, idx.shape[1], c_in)).astype(np.float32)
    jdown = jskip.gather(jnp.asarray(idx), jnp.asarray(iv)).with_features(
        jnp.asarray(xd))
    tdown = tskip.gather(*to_torch(idx, iv)).with_features(torch.from_numpy(xd))
    cls = jmod.FPStep if step.name == "fp" else jmod.CurveFPStep
    jm = cls(jspec, step, dims)
    variables = jax_init(jm, jdown, jskip)
    tmod = load_step(type(port.steps[i])(tspec, tstep, dims, c_in, skip_w),
                     variables, step)
    with torch.no_grad():
        tout = tmod(tdown, tskip)
    _check(_apply(jm, variables, jdown, jskip), tout)


@pytest.fixture(scope="module")
def slice_models(narrow):
    """The narrow flagship in both packages, same (perturbed) weights."""
    jspec, tspec = narrow
    pos, x, cid, valid = lidar(N_SLICE, batch=2, seed=0)
    jc, tc = _clouds(pos, x, cid, valid)
    jm = JNet(jspec, n_points=N_SLICE)
    variables = jax_init(jm, jc)
    tm = TNet(tspec, N_SLICE, feat_channels=1)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    return jm, variables, tm.eval(), jc, tc


def test_slice_logits_match_jax(slice_models):
    jm, variables, tm, jc, tc = slice_models
    want, jvalid = _apply(jm, variables, jc)
    with torch.no_grad():
        got, tvalid = tm(tc)
    valid = np.asarray(jvalid)
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    err = np.abs(got.numpy() - np.asarray(want))[valid]
    assert np.isfinite(got.numpy()[valid]).all()
    assert err.max() <= 2e-3, err.max()


def test_checkpoint_round_trip(slice_models, narrow):
    """port state_dict -> load_torch_checkpoint gives back the JAX trees
    leaf for leaf; from_jax_variables inverts it."""
    jspec, _ = narrow
    jm, variables, tm, _, _ = slice_models
    port = TNet(narrow[1], N_SLICE, feat_channels=1)
    predict.init_weights(port, torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = jckpt.load_torch_checkpoint(sd, jspec)
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path((params, stats))[0]}
    ref = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(
               (variables["params"], variables["batch_stats"]))[0]}
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.shape(got[k]) == np.shape(ref[k]), k
    back = tckpt.from_jax_variables(params, stats, jspec)
    assert back.keys() == port.state_dict().keys()
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


def test_launch_counts_follow_spec(slice_models, narrow, monkeypatch):
    """One forward calls each kernel wrapper as often as kernel_launches
    derives from the spec (on the CPU the wrappers run the plain versions;
    the count is taken at the wrapper boundary)."""
    _, _, tm, _, tc = slice_models
    seen = {}
    for mod, name, key in [(conv1d_chain, "conv1d_chain_eval", "conv1d_chain"),
                           (group_reduce, "group_reduce", "group_reduce"),
                           (knn, "knn_search", "knn"), (fps, "fps_picks", "fps"),
                           (gather, "gather_km", "gather")]:
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            seen[_key] = seen.get(_key, 0) + 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    with torch.no_grad():
        tm(tc)
    assert seen == kernel_launches(narrow[1], N_SLICE)
    assert kernel_launches(narrow[1], 36864) == {
        "conv1d_chain": 2, "group_reduce": 15, "gather": 10, "knn": 9,
        "fps": 2}


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import curvecloudnet_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_cuda_path_raises_without_a_card():
    """No quiet CPU fallback: the wrappers take CPU tensors to the plain
    version only; any other device goes to the kernel or raises."""
    x = torch.zeros(1, 8, 3, device="meta")
    v = torch.ones(1, 8, dtype=torch.bool, device="meta")
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        knn.knn_search(x, x, v, v, 4)
