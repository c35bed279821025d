"""The train path of the version-1.0 configs (A2D2, ShapeNet part
segmentation and classification, Kortx) and KITTI's train step: the port
against the JAX package on the CPU, same weights (``from_jax_variables``;
the whole steps' drawn with numpy by ``test_torch_port_eval.
random_variables``, which compiles no init) and same numpy inputs, widths
/ 8.

* each new train branch against its JAX module under ``jax.value_and_grad``
  (``mutable=["batch_stats"]``, a fixed cotangent): conv1d-fast-v1, ball
  sa with attend (query slots past the FPS budget included: no live plane,
  statistics without them), slow-order sgcnn with attend and with max,
  sa-global with max, the category head; outputs 1e-4, gradients within
  2e-3 of each parameter's largest (``_check_grads``), running statistics
  1e-5.  The JAX CPU referee runs its materialized grouping path and the
  split edge form (``CCN_SPLIT_EDGE=force``); the port runs K7's plain
  passes (K3's at k = 128 for the balls); the JAX searches run on direct
  differences (``torch_port_utils.direct_knn``), as in
  ``test_torch_port_v1.py``;
* the narrow audi, shapenet-seg, kortx and shapenet-class train steps
  against JAX's ``build_train_step`` loss (``_compute_loss`` with the
  task's loss): loss 1e-4 relative, logits 2e-3, running statistics 1e-5
  or the perturbation yardstick, every gradient within 3x the yardstick
  (JAX's own change under a 1e-6 weight perturbation) plus 2e-3 of its
  norm, as ``test_torch_port_train_model.py`` holds the flagship;
* the narrow KITTI train step (n_pad 4096, the table limit lowered to 1024
  so two rows take the grid: ``test_torch_port_kitti.lower_limits``), the
  same bars but its logits within 2e-3 plus JAX's own change under the
  perturbation: through 33 train-mode BatchNorms they miss a flat 2e-3;
* ``classification_loss`` against JAX's, ``loss_for`` against JAX's task
  loss with the config's Lovász override for all six configs;
* ``kernel_launches(train=True)`` of the four version-1.0 specs against the
  launches a train step makes: wrapper calls of K3, K4, K4b and K6, and
  K7's kernel launches counted by running its host code at each recorded
  site against a stand-in library; the full-size counts pinned;
* the train entry's batches for every shipped config.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvecloudnet_tpu import main as jmain
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import modules as jmod
from curvecloudnet_tpu.ops import neighbors as jnb
from curvecloudnet_tpu.run import losses as jlosses
from curvecloudnet_tpu.run import tasks as JT
from curvecloudnet_tpu.train import Batch as JBatch
from curvecloudnet_tpu.train.trainer import _compute_loss
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import kernel_launches
from curvecloudnet_tpu_torch.ops import _build, fps, gather, group_train, knn
from curvecloudnet_tpu_torch.run import losses as tlosses
from curvecloudnet_tpu_torch.run import tasks as TT
from curvecloudnet_tpu_torch.train import Batch
from curvecloudnet_tpu_torch.train.__main__ import train_batch
from curvecloudnet_tpu_torch.train.trainer import (compute_loss,
                                                   create_optimizer,
                                                   train_step)
from test_torch_port_eval import random_variables
from test_torch_port_train_model import (_check_grads, _check_stats,
                                         _running_stats)
from test_torch_port_v1 import CONFIGS, REPO, _cfg, _clouds, _objects, _specs
from torch_port_utils import direct_knn, jax_init, lidar, load_step

torch.set_num_threads(1)
MOMENTUM = 0.1


@pytest.fixture(scope="module")
def narrow():
    return {name: _specs(name) for name in CONFIGS}


def _cotangent(shape, xp):
    return xp.sin(xp.arange(int(np.prod(shape)), dtype=xp.float32)).reshape(
        shape)


# (config, step index, row size): the branches new in train
BRANCHES = [
    ("audi", 2, 1024),             # conv1d-fast-v1
    ("kortx-testsplit", 2, 1024),  # conv1d-fast-v1, kernel 7
    ("audi", 4, 1024),             # ball sa, attend, slots past the budget
    ("shapenet-seg", 4, 1024),     # ball sa on object scans
    ("audi", 5, 768),              # slow-order sgcnn, attend
    ("shapenet-seg", 5, 1024),     # slow-order sgcnn, max
    ("shapenet-class", 14, 256),   # sa-global, max
]


@pytest.mark.parametrize("name,i,n", BRANCHES)
def test_train_branch_matches_jax(narrow, name, i, n, monkeypatch):
    monkeypatch.setattr(jnb, "knn", direct_knn)
    monkeypatch.setenv("CCN_SPLIT_EDGE", "force")
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
            "sgcnn": (tspec, tstep, dims, c_in, None),
            "sa": (tspec, tstep, dims, c_in, budget, None),
            "sa-global": (tspec, tstep, dims, c_in)}[step.name]
    tm = load_step(type(port.steps[i])(*args), variables, step)

    def jloss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, jc,
                            train=True, bn_momentum=MOMENTUM,
                            mutable=["batch_stats"])
        r = _cotangent(out.x.shape, jnp)
        return jnp.sum(out.x * r * out.valid[..., None]), (out, mut)

    (_, (jout, mut)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tout = (tm(tc, None, train=True, bn_momentum=MOMENTUM)
            if step.name in ("sa", "sgcnn")
            else tm(tc, train=True, bn_momentum=MOMENTUM))
    (tout.x * _cotangent(tout.x.shape, torch) * tout.valid[..., None]
     ).sum().backward()
    v = np.asarray(jout.valid)
    np.testing.assert_array_equal(tout.valid.numpy(), v)
    if step.name == "sa" and not objects:
        # query slots past the FPS budget: no live plane, out of the loss
        assert (~v).any()
    np.testing.assert_allclose(tout.x.detach().numpy()[v],
                               np.asarray(jout.x)[v], rtol=1e-4, atol=1e-4)
    sname, prefix = f"step_0_{step.name}", "steps.0."   # one-step spec
    one = SimpleNamespace(steps=(step,))
    want = tckpt.from_jax_variables({sname: jg}, {}, one)
    _check_grads(((prefix + k, p) for k, p in tm.named_parameters()), want)
    _check_stats(tm.named_buffers(), _running_stats(
        {sname: jg}, {sname: mut["batch_stats"]}, one, prefix), 1e-5)


def test_sa_global_max_gradient_skips_the_fill():
    """A padded row's -1e30 fill takes none of the max's gradient; a tie
    between two valid rows splits it evenly, as ``jnp.max`` does."""
    x = torch.tensor([[[1.0], [3.0], [3.0], [0.0]]], requires_grad=True)
    mask = torch.tensor([[[True], [True], [True], [False]]])
    torch.where(mask, x, torch.full_like(x, -1e30)).amax(1).sum().backward()
    jg = jax.grad(lambda a: jnp.max(jnp.where(np.asarray(mask), a, -1e30),
                                    axis=1).sum())(jnp.asarray(x.detach()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    assert x.grad[0, 3, 0] == 0 and x.grad[0, 1, 0] == 0.5


def test_category_head_train_matches_jax(narrow):
    """The ShapeNet part-segmentation model cut to its mlp step, its
    category head (16 -> 64 -> 64 on (B, 1, 16) one-hots, BatchNorm over
    the B samples) in train."""
    jspec, tspec, _ = narrow["shapenet-seg"]
    jspec = dataclasses.replace(jspec, steps=jspec.steps[1:2])
    tspec = dataclasses.replace(tspec, steps=tspec.steps[1:2])
    n = 256
    pos, cid, valid, cats = _objects(n, batch=3, seed=3)
    jc, tc = _clouds(pos, None, cid, valid)
    jm = JNet(jspec, n_points=n)
    variables = jax_init(jm, jc, jnp.asarray(cats), seed=3)
    tm = TNet(tspec, n)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)

    def jloss(params):
        (logits, out_valid), mut = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jc,
            jnp.asarray(cats), train=True, bn_momentum=MOMENTUM,
            mutable=["batch_stats"])
        r = _cotangent(logits.shape, jnp)
        return jnp.sum(logits * r * out_valid[..., None]), (logits, mut)

    (_, (jlogits, mut)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"])
    logits, out_valid = tm(tc, torch.from_numpy(cats), train=True,
                           bn_momentum=MOMENTUM)
    (logits * _cotangent(logits.shape, torch) * out_valid[..., None]
     ).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy()[valid],
                               np.asarray(jlogits)[valid], rtol=1e-4,
                               atol=1e-4)
    want = tckpt.from_jax_variables(jg, {}, jspec)
    assert any(k.startswith("lin_categorical") for k in want)
    _check_grads(tm.named_parameters(), want)
    _check_stats(tm.named_buffers(), _running_stats(
        jg, mut["batch_stats"], jspec), 1e-5)


# ---------------------------------------------------------------------------
# whole narrow train steps
# ---------------------------------------------------------------------------

def _labels(task, n_out, valid, cats, parts, seed):
    if task == "shapenet-class":
        return cats
    if parts is not None:
        return parts
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_out, size=valid.shape).astype(np.int32)


def _yardstick_step(jm, variables, jc, jcats, jbatch, jloss_cfg):
    """JAX's loss, logits, running statistics and gradients of one train
    step, and its gradients and statistics after a 1e-6 relative weight
    perturbation (the yardstick)."""

    @jax.jit
    def jstep(params, batch_stats):
        def loss_fn(p):
            (logits, out_valid), mut = jm.apply(
                {"params": p, "batch_stats": batch_stats}, jc, jcats,
                train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"])
            loss = _compute_loss(logits, out_valid, jbatch, jloss_cfg, None)
            return loss, (logits, mut["batch_stats"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (jl, (jlogits, jbs)), jg = jstep(variables["params"],
                                     variables["batch_stats"])
    leaves, tdef = jax.tree_util.tree_flatten(variables["params"])
    noise = np.random.default_rng(9)
    shaken = jax.tree_util.tree_unflatten(tdef, [
        leaf * (1 + 1e-6 * noise.standard_normal(leaf.shape)).astype(
            np.float32) for leaf in leaves])
    (_, (slogits, sbs)), sg = jstep(shaken, variables["batch_stats"])
    return jl, jlogits, jbs, jg, sbs, sg, slogits


def _check_step(jspec, tm, loss, logits, valid, j, logit_noise=False):
    """The bars of a whole train step (see the module docstring); with
    ``logit_noise`` the logits are held to 2e-3 plus JAX's own change under
    the 1e-6 weight perturbation, else to 2e-3."""
    jl, jlogits, jbs, jg, sbs, sg, slogits = j
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    err = np.abs(logits.detach().numpy() - np.asarray(jlogits))[valid].max()
    noise = np.abs(np.asarray(slogits) - np.asarray(jlogits))[valid].max()
    assert err <= 2e-3 + (noise if logit_noise else 0.0), (err, noise)
    want = tckpt.from_jax_variables(jg, {}, jspec)
    shaken = tckpt.from_jax_variables(sg, {}, jspec)
    got = dict(tm.named_parameters())
    assert want.keys() == got.keys()
    for name, g in want.items():
        e = float((got[name].grad - g).norm())
        noise = float((shaken[name] - g).norm())
        assert e <= 3 * noise + 2e-3 * float(g.norm()), (name, e, noise)
    stats = _running_stats(jg, jbs, jspec)
    stats_s = _running_stats(jg, sbs, jspec)
    bufs = dict(tm.named_buffers())
    assert stats.keys() == bufs.keys()
    for name, v in stats.items():
        e = float((bufs[name] - v).abs().max())
        scale = max(1.0, float(v.abs().max()))
        noise = float((stats_s[name] - v).abs().max())
        assert e <= 1e-5 * scale or e <= 3 * noise + 1e-5 * scale, (
            name, e, noise)


# config -> (row size, batch)
STEPS = {"audi": (1024, 2), "shapenet-seg": (1024, 2),
         "kortx-testsplit": (1024, 2), "shapenet-class": (1024, 2)}


@pytest.mark.parametrize("name", list(STEPS))
def test_narrow_train_step_matches_jax(narrow, name, monkeypatch):
    monkeypatch.setattr(jnb, "knn", direct_knn)
    monkeypatch.setenv("CCN_SPLIT_EDGE", "force")
    jspec, tspec, task = narrow[name]
    n, b = STEPS[name]
    cfg = _cfg(name)
    parts = None
    if task in predict.OBJECT_TASKS:
        from curvecloudnet_tpu.data.synthetic import synthetic_object_batch

        pos, cid, valid, parts, cats = synthetic_object_batch(
            np.random.default_rng(0), b, n)
        x = None
    else:
        pos, x, cid, valid = lidar(n, batch=b, seed=0)
        cats = np.zeros((b,), np.int32)
    labels = _labels(task, jspec.n_out, valid, cats, parts, seed=1)
    jc, tc = _clouds(pos, x, cid, valid)
    jcats = jnp.asarray(cats) if jspec.with_seg_category else None
    jm = JNet(jspec, n_points=n)
    variables = random_variables(jm, jc, jcats)
    info = JT.task_for(cfg["dataset_source"], cfg.get("task", "segmentation"))
    jloss_cfg = jmain.dataclasses_replace_lovasz(info.loss_cfg, cfg)
    jbatch = JBatch(cloud=jc, labels=jnp.asarray(labels),
                    categories=jnp.asarray(cats))
    j = _yardstick_step(jm, variables, jc, jcats, jbatch, jloss_cfg)
    tm = TNet(tspec, n, feat_channels=None if x is None else 1)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    batch = Batch(cloud=tc, labels=torch.from_numpy(labels),
                  categories=torch.from_numpy(cats))
    logits, out_valid = tm(tc, batch.categories if jspec.with_seg_category
                           else None, train=True, bn_momentum=MOMENTUM)
    loss = compute_loss(logits, out_valid, batch, TT.loss_for(cfg))
    loss.backward()
    rows = np.asarray(out_valid)
    _check_step(jspec, tm, loss, logits, rows, j)


def test_narrow_kitti_train_step_matches_jax(monkeypatch):
    """KITTI's train step (NLL over every valid point + 2 x Lovász), the
    port's 2304- and 1152-point rows on the grid (K5's plain version) at
    the lowered table limit.  The JAX referee searches exactly, on direct
    differences: its grid ranks candidates by d2 quantized to ~1e-4
    relative (on the CPU its packed min-extraction, on its accelerator
    route too), so a point that close to the k-th distance can displace
    a nearer one (a 2304-point row of this sweep has one), which
    train-mode BatchNorm spreads over every row downstream; the port's
    grid ranks by exact d2 and drops nothing here, so its tables are the
    exact ones."""
    from curvecloudnet_tpu.data.synthetic import synthetic_lidar_batch
    from test_torch_port_kitti import N_PAD, lower_limits

    from curvecloudnet_tpu_torch.config import load_config
    from curvecloudnet_tpu_torch.ops import grid_topk

    lower_limits(monkeypatch)
    monkeypatch.setattr(jnb, "knn", direct_knn)
    grid_calls = []
    records = grid_topk.grid_topk_records
    monkeypatch.setattr(grid_topk, "grid_topk_records", lambda *a, **kw: (
        grid_calls.append(a[3].shape), records(*a, **kw))[1])
    monkeypatch.setenv("CCN_SPLIT_EDGE", "force")
    jspec, tspec, _ = _specs("kitti")
    cfg = load_config(os.path.join(REPO, "configs", "kitti.yaml"))
    pos, x, cid, valid, labels = synthetic_lidar_batch(
        np.random.default_rng(0), 1, N_PAD, n_beams=predict.N_BEAMS["kitti"],
        n_classes=predict.N_OUT["kitti"])
    jc, tc = _clouds(pos, x, cid, valid)
    jm = JNet(jspec, n_points=N_PAD)
    variables = random_variables(jm, jc)
    jloss_cfg = jmain.dataclasses_replace_lovasz(JT.TASKS["kitti"].loss_cfg,
                                                 cfg)
    j = _yardstick_step(jm, variables, jc, None,
                        JBatch(cloud=jc, labels=jnp.asarray(labels)),
                        jloss_cfg)
    tm = TNet(tspec, N_PAD, feat_channels=1)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    logits, out_valid = tm(tc, train=True, bn_momentum=MOMENTUM)
    loss = compute_loss(logits, out_valid,
                        Batch(cloud=tc, labels=torch.from_numpy(labels)),
                        TT.loss_for(cfg))
    loss.backward()
    # KITTI's 33 train-mode BatchNorms: JAX's own logits move by 5.0e-2
    # under the 1e-6 perturbation and the port's differ from JAX's by
    # 7.0e-3, past the flat 2e-3 the version-1.0 steps meet (4.4e-4 at
    # worst)
    _check_step(jspec, tm, loss, logits, np.asarray(out_valid), j,
                logit_noise=True)
    assert len(grid_calls) == 2, grid_calls


# ---------------------------------------------------------------------------
# losses, launches, the entry's batches
# ---------------------------------------------------------------------------

def test_classification_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(7, 16))).astype(np.float32)
    labels = rng.integers(0, 16, size=7).astype(np.int32)
    want = jlosses.classification_loss(jnp.asarray(logits),
                                       jnp.asarray(labels))
    got = tlosses.classification_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


SHIPPED = ("nuscenes", "kitti", "audi", "shapenet-seg", "kortx-testsplit",
           "shapenet-class")


@pytest.mark.parametrize("name", SHIPPED)
@pytest.mark.parametrize("ce_weights", [False, True])
def test_loss_for_matches_jax_task_loss(name, ce_weights):
    cfg = dict(_cfg(name), use_ce_weights=ce_weights)
    info = JT.task_for(cfg["dataset_source"], cfg.get("task", "segmentation"))
    want = jmain.dataclasses_replace_lovasz(info.loss_cfg, cfg)
    got = TT.loss_for(cfg)
    for f in ("task", "ignore_index", "use_lovasz", "lovasz_weight",
              "mean_over_all"):
        assert getattr(got, f) == getattr(want, f), f
    if ce_weights and info.class_weights is not None:
        np.testing.assert_array_equal(np.float32(got.class_weights),
                                      np.float32(info.class_weights))
    else:
        assert got.class_weights is None


def _stand_in_launches(monkeypatch, calls):
    """K7's launches at each recorded (h1, mask, cfg, params) site: its
    kernel host code run against a stand-in library that launches
    nothing -> (forward, backward) counts."""
    class Library:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(group_train, "_dptr", lambda t: None)
    monkeypatch.setattr(group_train, "_sm_count", lambda dev: 132)
    fwd = bwd = 0
    for h1, mask, cfg, params in calls:
        params = [p.detach() for p in params]
        group_train.group_train_fwd.launches = 0
        group_train.group_train_bwd.launches = 0
        out, stats, _, extras = group_train._kernel_fwd(h1.detach(), mask,
                                                        cfg, params)
        group_train._kernel_bwd(h1.detach(), mask, cfg, params, stats,
                                extras, torch.zeros_like(out))
        fwd += group_train.group_train_fwd.launches
        bwd += group_train.group_train_bwd.launches
    return fwd, bwd


@pytest.mark.parametrize("name", CONFIGS)
def test_train_launch_counts_follow_spec(narrow, name, monkeypatch):
    """One narrow train step on the CPU (the wrappers run their plain
    versions): the K3, K4, K4b and K6 wrapper calls, and K7's kernel
    launches at the step's sites, equal ``kernel_launches(train=True)``;
    nothing of K8 (conv1d-fast-v1 is plain torch)."""
    _, tspec, task = narrow[name]
    n = 1024
    seen, sites = {}, []
    for mod, fn, key in [(knn, "knn_search", "knn"), (fps, "fps_picks", "fps"),
                         (gather, "gather_km", "gather"),
                         (gather, "scatter_km", "scatter"),
                         (group_train, "group_train_fwd", None)]:
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _key=key, **kw):
            if _key is None:
                sites.append(a[:4])
            else:
                seen[_key] = seen.get(_key, 0) + 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, fn, counted)
    tm = TNet(tspec, n, feat_channels=None if task in predict.OBJECT_TASKS
              else 1)
    predict.init_weights(tm, torch.Generator().manual_seed(0))
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    batch = train_batch(path, 0, n, "cpu")
    if task in predict.OBJECT_TASKS:   # two scans of the config's batch
        cloud = batch.cloud
        batch = Batch(cloud=dataclasses.replace(cloud, **{
            f: getattr(cloud, f)[:2] for f in ("pos", "valid", "curve_id",
                                                 "parent_idx")
            if getattr(cloud, f) is not None}), labels=batch.labels[:2],
            categories=batch.categories[:2])
    out = train_step(tm, create_optimizer(tm), 1e-3, batch,
                     torch.Generator().manual_seed(0), MOMENTUM,
                     TT.loss_for(_cfg(name)))
    assert np.isfinite(float(out["loss"]))
    want = {k: v for k, v in kernel_launches(tspec, n, train=True).items()
            if v}
    fwd, bwd = _stand_in_launches(monkeypatch, sites)
    got = dict(seen, group_train_fwd=fwd, group_train_bwd=bwd)
    assert got == want
    assert "conv1d_train_fwd" not in want


# the full-size launches of a train step (nothing depends on the batch)
FULL_TRAIN_LAUNCHES = {
    "audi": {"group_train_fwd": 80, "group_train_bwd": 130, "gather": 6,
             "scatter": 6, "knn": 9, "fps": 3},
    "shapenet-seg": {"group_train_fwd": 64, "group_train_bwd": 92,
                     "gather": 6, "scatter": 6, "knn": 9, "fps": 3},
    "kortx-testsplit": {"group_train_fwd": 62, "group_train_bwd": 88,
                        "gather": 6, "scatter": 6, "knn": 9, "fps": 3},
    "shapenet-class": {"group_train_fwd": 54, "group_train_bwd": 80,
                       "gather": 4, "scatter": 4, "knn": 6, "fps": 3},
}


@pytest.mark.parametrize("name", list(FULL_TRAIN_LAUNCHES))
def test_full_size_train_launch_counts(name):
    """At the published widths: K7 2L + 2 forward and 4L backward a site
    of L kernel-side denses, 3 and 7 more under attend; K4/K4b once a
    sgcnn step; K3 once a ball sa step, an exact table or an fp sweep; K6
    once an FPS step; no K8."""
    _, tspec, _ = _specs(name, factor=None)
    n = predict.n_pad_of(os.path.join(REPO, "configs", f"{name}.yaml"))
    got = {k: v for k, v in kernel_launches(tspec, n, train=True).items()
           if v}
    assert got == FULL_TRAIN_LAUNCHES[name]


@pytest.mark.parametrize("name", SHIPPED)
def test_train_entry_batches(name):
    """``train.__main__.train_batch``: a lidar config's sweep of its sensor
    at B=1 with its class count; an object config's scans at its
    batch_size with part labels, or categories as labels for
    classification."""
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    task = predict.dataset_of(path)
    batch = train_batch(path, 0, 512, "cpu")
    valid = batch.cloud.valid
    if task in predict.OBJECT_TASKS:
        assert valid.shape == (int(_cfg(name)["batch_size"]), 512)
        assert batch.categories is not None
        if task == "shapenet-class":
            assert torch.equal(batch.labels, batch.categories)
        else:
            assert batch.labels.shape == valid.shape
    else:
        assert valid.shape == (1, 512)
        cid = batch.cloud.curve_id[valid]
        assert int(cid.max()) + 1 <= predict.N_BEAMS[task]
        assert int(batch.labels.max()) < predict.N_OUT[task]
