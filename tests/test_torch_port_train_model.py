"""The port's train path against the JAX package on the CPU, same weights
(carried by ``from_jax_variables``) and same numpy inputs.

* each grouping and conv step module of the flagship in train mode
  against its JAX module (``apply(..., train=True, mutable=["batch_stats"])``):
  outputs 1e-4, the updated running statistics 1e-5, and the gradient of
  every parameter under a fixed cotangent within 2e-3 of that parameter's
  largest gradient.  The JAX CPU referee runs the materialized grouping
  path (the port runs K7's passes: E[x^2] - mean^2 statistics against
  two-pass ones) and, with ``CCN_SPLIT_EDGE=force``, the edge conv's split
  message form, as the port does;
* the slice: the narrow flagship (widths / 8, n_pad 2048, B=2, the
  deterministic sampling point) through ``jax.value_and_grad`` of the
  nuScenes loss (NLL + Lovász, ignore 0): loss 1e-4 relative, logits
  2e-3, running statistics 1e-4, every gradient against a yardstick of
  JAX's own rounding sensitivity (see the test);
* three port train steps lower the loss; the weight bridge carries
  gradients and running statistics by name.
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
from curvecloudnet_tpu.data.synthetic import synthetic_lidar_batch
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
from curvecloudnet_tpu.models import modules as jmod
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.run import losses as jlosses
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.run import losses as tlosses
from curvecloudnet_tpu_torch.train import Batch, LossConfig, train_step
from curvecloudnet_tpu_torch.train.trainer import create_optimizer
from torch_port_utils import jax_init, lidar, load_step, to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLICE = 2048
MOMENTUM = 0.1


@pytest.fixture(scope="module")
def narrow():
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    mc = _shrink_feat_dims(cfg["model"], 8)
    return jparse(mc, in_dim=4, n_out=17), tparse(mc, in_dim=4, n_out=17)


def _clouds(pos, x, cid, valid):
    return (jcloud(*map(jnp.asarray, (pos, cid, valid, x))),
            tcloud(*to_torch(pos, cid, valid, x)))


def _check_grads(named, want):
    """Gradients by name: within 2e-3 of the parameter's largest gradient,
    plus 1e-5 of the largest gradient anywhere (the floor for gradients
    that are zero in exact arithmetic, e.g. a bias feeding a BatchNorm)."""
    got = dict(named)
    assert want.keys() == got.keys()
    floor = 1e-5 * max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        g = g.numpy()
        assert got[name].grad is not None, name
        err = np.abs(got[name].grad.numpy() - g).max()
        assert err <= 2e-3 * np.abs(g).max() + floor, (name, err)


def _running_stats(params, batch_stats, spec, prefix=""):
    """JAX batch_stats under the port's buffer names (the bridge walks the
    params tree, so it is given the params' structure)."""
    sd = tckpt.from_jax_variables(params, batch_stats, spec)
    return {k[len(prefix):]: v for k, v in sd.items() if ".running_" in k}


def _check_stats(named_buffers, want, tol):
    bufs = dict(named_buffers)
    assert want.keys() == bufs.keys()
    for name, v in want.items():
        np.testing.assert_allclose(bufs[name].numpy(), v.numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


# step index in the flagship -> row size the module test runs at
TRAIN_STEPS = [(0, 512), (1, 512), (3, 512), (5, 768), (14, 384)]


@pytest.mark.parametrize("i,n", TRAIN_STEPS)
def test_train_step_module_matches_jax(narrow, i, n, monkeypatch):
    monkeypatch.setenv("CCN_SPLIT_EDGE", "force")
    jspec, tspec = narrow
    step, tstep = jspec.steps[i], tspec.steps[i]
    port_net = TNet(tspec, n, feat_channels=1)
    c_in = port_net.in_widths[i]
    pos, x, cid, valid = lidar(n, seed=i, feat=c_in)
    jc, tc = _clouds(pos, x, cid, valid)
    dims = jspec.input_dim(i)
    budget = step.out_budget(n)
    jm = {"conv1d-fast-v2": lambda: jmod.SymmetricCurveConvStep(jspec, step, dims),
          "sa-geo": lambda: jmod.CurveSAStep(jspec, step, dims, budget),
          "sgcnn": lambda: jmod.EdgeConvStep(jspec, step, dims),
          "sa": lambda: jmod.SAStep(jspec, step, dims, budget)}[step.name]()
    variables = jax_init(jm, jc, seed=i)
    args = {"conv1d-fast-v2": (tspec, tstep, c_in),
            "sa-geo": (tspec, tstep, dims, c_in, budget),
            "sgcnn": (tspec, tstep, dims, c_in, None),
            "sa": (tspec, tstep, dims, c_in, budget, None)}[step.name]
    tmod = load_step(type(port_net.steps[i])(*args), variables, step)

    def jloss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, jc,
                            train=True, bn_momentum=MOMENTUM,
                            mutable=["batch_stats"])
        r = jnp.sin(jnp.arange(out.x.size, dtype=jnp.float32)).reshape(
            out.x.shape)
        return jnp.sum(out.x * r * out.valid[..., None]), (out, mut)

    (_, (jout, mut)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tout = (tmod(tc, None, train=True, bn_momentum=MOMENTUM)
            if step.name in ("sa", "sgcnn")
            else tmod(tc, train=True, bn_momentum=MOMENTUM))
    r = torch.sin(torch.arange(tout.x.numel(), dtype=torch.float32)).reshape(
        tout.x.shape)
    (tout.x * r * tout.valid[..., None]).sum().backward()
    v = np.asarray(jout.valid)
    np.testing.assert_array_equal(tout.valid.numpy(), v)
    np.testing.assert_allclose(tout.x.detach().numpy()[v],
                               np.asarray(jout.x)[v], rtol=1e-4, atol=1e-4)
    name, prefix = f"step_0_{step.name}", "steps.0."   # one-step spec
    from types import SimpleNamespace

    one = SimpleNamespace(steps=(step,))
    want = tckpt.from_jax_variables({name: jg}, {}, one)
    _check_grads(((prefix + k, p) for k, p in tmod.named_parameters()), want)
    _check_stats(tmod.named_buffers(), _running_stats(
        {name: jg}, {name: mut["batch_stats"]}, one, prefix), 1e-5)


@pytest.fixture(scope="module")
def slice_train(narrow):
    """One train forward + backward of the narrow flagship in both
    packages from the same weights."""
    jspec, tspec = narrow
    rng = np.random.default_rng(0)
    pos, x, cid, valid, labels = synthetic_lidar_batch(rng, 2, N_SLICE)
    jc, tc = _clouds(pos, x, cid, valid)
    jm = JNet(jspec, n_points=N_SLICE)
    variables = jax_init(jm, jc)

    @jax.jit
    def jstep(params, batch_stats):
        def loss_fn(p):
            (logits, out_valid), mut = jm.apply(
                {"params": p, "batch_stats": batch_stats}, jc, train=True,
                bn_momentum=MOMENTUM, mutable=["batch_stats"])
            loss = jlosses.seg_loss(logits, labels, out_valid & valid,
                                    ignore_index=0, use_lovasz=True)
            return loss, (logits, mut["batch_stats"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (jl, (jlogits, jbs)), jg = jstep(variables["params"],
                                     variables["batch_stats"])
    # the yardstick: JAX's own gradients after a 1e-6 relative weight
    # perturbation (rounding-sized), which train-mode BatchNorm over 33
    # steps amplifies to percents at the first steps
    leaves, tdef = jax.tree_util.tree_flatten(variables["params"])
    noise = np.random.default_rng(9)
    shaken = jax.tree_util.tree_unflatten(tdef, [
        leaf * (1 + 1e-6 * noise.standard_normal(leaf.shape)).astype(
            np.float32) for leaf in leaves])
    _, jg_shaken = jstep(shaken, variables["batch_stats"])
    tm = TNet(tspec, N_SLICE, feat_channels=1)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    logits, out_valid = tm(tc, train=True, bn_momentum=MOMENTUM)
    loss = tlosses.seg_loss(logits, torch.from_numpy(labels),
                            out_valid & torch.from_numpy(valid),
                            ignore_index=0, use_lovasz=True)
    loss.backward()
    return dict(jl=jl, jlogits=jlogits, jbs=jbs, jg=jg, tm=tm, loss=loss,
                jparams=variables["params"], jg_shaken=jg_shaken,
                logits=logits, valid=valid, jspec=jspec, tc=tc,
                labels=labels)


def test_slice_train_loss_and_logits_match_jax(slice_train):
    s = slice_train
    v = s["valid"]
    np.testing.assert_allclose(float(s["loss"].detach()), float(s["jl"]), rtol=1e-4)
    err = np.abs(s["logits"].detach().numpy() - np.asarray(s["jlogits"]))[v]
    assert err.max() <= 2e-3, err.max()


def test_slice_train_gradients_match_jax(slice_train):
    """Train-mode BatchNorm over the 33 steps amplifies rounding-sized
    differences (JAX's own gradients move by up to ~2x their norm at
    zero-in-exact-arithmetic biases and ~10% at the first convs under a
    1e-6 weight perturbation), so each parameter's gradient error (L2) is
    held to 3x that yardstick plus 2e-3 of the gradient's norm; the port
    measured a median of 0.43x the yardstick, 2.0x at worst."""
    s = slice_train
    want = tckpt.from_jax_variables(s["jg"], {}, s["jspec"])
    shaken = tckpt.from_jax_variables(s["jg_shaken"], {}, s["jspec"])
    got = dict(s["tm"].named_parameters())
    assert want.keys() == got.keys()
    for name, g in want.items():
        err = float((got[name].grad - g).norm())
        noise = float((shaken[name] - g).norm())
        assert err <= 3 * noise + 2e-3 * float(g.norm()), (name, err, noise)


def test_slice_train_running_stats_match_jax(slice_train):
    s = slice_train
    _check_stats(s["tm"].named_buffers(),
                 _running_stats(s["jparams"], s["jbs"], s["jspec"]), 1e-4)


def test_port_train_steps_lower_the_loss(narrow):
    _, tspec = narrow
    rng = np.random.default_rng(1)
    pos, x, cid, valid, labels = synthetic_lidar_batch(rng, 2, N_SLICE)
    model = TNet(tspec, N_SLICE, feat_channels=1)
    from curvecloudnet_tpu_torch.predict import init_weights

    init_weights(model, torch.Generator().manual_seed(0))
    batch = Batch(cloud=tcloud(*to_torch(pos, cid, valid, x)),
                  labels=torch.from_numpy(labels))
    opt = create_optimizer(model)
    gen = torch.Generator().manual_seed(0)
    losses = [float(train_step(model, opt, 1e-3, batch, gen, MOMENTUM,
                               LossConfig(use_lovasz=True))["loss"])
              for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_weight_bridge_carries_grads_and_running_stats(slice_train):
    """grads map by the params' names; running statistics survive the
    state-dict round trip through the reference's torch names."""
    s = slice_train
    tm, jspec = s["tm"], s["jspec"]
    want = tckpt.from_jax_variables(s["jg"], {}, jspec)
    assert want.keys() == dict(tm.named_parameters()).keys()
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    params, stats = jckpt.load_torch_checkpoint(sd, jspec)
    back = tckpt.from_jax_variables(params, stats, jspec)
    for name, buf in tm.named_buffers():
        np.testing.assert_array_equal(back[name].numpy(), buf.numpy())
