"""The narrow ``shapenet-class-options`` model on the port against the JAX
package on the CPU: shapenet-class with phase 19's substitutions
(``chip_smoke.options_model``: a dgcnn-rad step prepended, sa-geo on FPS,
curve-fps with a one-layer MLP, random and mean sa steps, a dgcnn step,
weighted-sum, fast-order attend, head dropout 0.5) at widths / 8, two
object scans of 1024 points, the same weights drawn with numpy.

* eval: logits within 2e-3 (the random step fed JAX's ``PRNGKey(0)``
  draws, the ``key=None`` point of both packages' samplers otherwise);
* one train step (the classification loss): loss within 1e-4, logits
  2e-3, every gradient within 3x JAX's own change under a 1e-6 weight
  perturbation plus 2e-3 of its norm and running statistics 1e-5 or that
  yardstick (``test_torch_port_train_v1._check_step``); the head's
  dropout masks read from JAX's ``nn.Dropout`` outputs and fed to the
  port;
* launches: one eval forward and one train step of the narrow model
  count each wrapper as ``kernel_launches`` derives from the spec (K7's
  through its host code on a stand-in library); the full-size counts of
  the options model and of nuScenes with a one-tap first conv pinned;
* head dropout alone: JAX's keep-masks read from the zero pattern of its
  ``nn.Dropout`` outputs (``capture_intermediates``) and fed to the
  port's MLP: outputs and gradients;
* ``MetricLogger(use_wandb=True)`` without wandb: one printed line, then
  the JSONL records of JAX's logger; ``main --use_wandb true`` runs to its
  end with the metrics.jsonl keys of JAX's ``main``;
* the module-level cases of each option: ``test_torch_port_options.py``.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu import logging_utils as jlog
from curvecloudnet_tpu import main as jmain
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.data.synthetic import synthetic_object_batch
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import layers as jlayers
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import neighbors as jnb
from curvecloudnet_tpu.run import tasks as JT
from curvecloudnet_tpu.train import Batch as JBatch
from curvecloudnet_tpu.train.trainer import _compute_loss
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import logging_utils as tlog
from curvecloudnet_tpu_torch import main as tmain
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import kernel_launches
from curvecloudnet_tpu_torch.models import layers as tlayers
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.ops import (fps, gather, group_reduce,
                                         group_train, knn)
from curvecloudnet_tpu_torch.run import tasks as TT
from curvecloudnet_tpu_torch.train import Batch
from curvecloudnet_tpu_torch.train.trainer import compute_loss
from test_torch_port_eval import random_variables
from test_torch_port_main_train import _cfg as _main_cfg
from test_torch_port_main_train import _weights
from test_torch_port_options import _cotangent, _direct_3d, _random_draws
from test_torch_port_train_model import _check_grads
from test_torch_port_train_v1 import _check_step, _stand_in_launches
from test_torch_port_v1 import _clouds

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B = 1024, 2
MOMENTUM = 0.1
LOGIT_TOL = 2e-3
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg():
    return load_config(chip_smoke.OPTIONS_CONFIG)


def _specs(factor=8):
    mc = chip_smoke.options_model(_cfg()["model"])
    if factor:
        mc = _shrink_feat_dims(mc, factor)
    n_out = predict.N_OUT["shapenet-class"]
    return (jparse(mc, in_dim=predict.OBJECT_IN_DIM, n_out=n_out),
            tparse(mc, in_dim=predict.OBJECT_IN_DIM, n_out=n_out))


@pytest.fixture(scope="module")
def model():
    jspec, tspec = _specs()
    pos, cid, valid, _, cats = synthetic_object_batch(
        np.random.default_rng(0), B, N)
    jc, tc = _clouds(pos, None, cid, valid)
    jm = JNet(jspec, n_points=N)
    variables = random_variables(jm, jc)
    tm = TNet(tspec, N)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    return dict(jspec=jspec, tspec=tspec, jm=jm, variables=variables, tm=tm,
                jc=jc, tc=tc, cats=cats)


def test_options_spec_substitutions():
    """The prepended dgcnn-rad infers its width as step 0 (JAX's
    ``input_dim`` refuses it anywhere else); every option is present."""
    jspec, tspec = _specs(factor=None)
    assert jspec == jparse(chip_smoke.options_model(_cfg()["model"]),
                           in_dim=3, n_out=predict.N_OUT["shapenet-class"])
    steps = tspec.steps
    assert [s.name for s in steps[:2]] == ["dgcnn-rad", "sa-geo"]
    assert tspec.input_dim(0) == (3, 64, 64)
    assert not steps[1].use_curve_fps and steps[1].ratio == 0.5
    assert steps[5].downsample_type == "curve-fps" and \
        steps[5].feat_dims == (128,)
    assert steps[6].name == "dgcnn" and steps[6].knn == 30
    assert [steps[i].downsample_type for i in (8, 11)] == ["random", "fps"]
    assert [steps[i].aggr_type for i in (9, 11, 12)] == [
        "weighted-sum", "mean", "attend"]
    assert not steps[12].use_sparse_feat_agg
    assert tspec.out_mlp_dropout == 0.5
    assert "dgcnn" in tspec.skip_connect_state_store


def test_options_eval_logits_match_jax(model, monkeypatch):
    monkeypatch.setattr(jnb, "knn", _direct_3d)
    monkeypatch.setattr(TNet, "_draws", staticmethod(_random_draws))
    m = model
    want, jvalid = jax.jit(lambda v, c: m["jm"].apply(v, c, train=False))(
        m["variables"], m["jc"])
    with torch.no_grad():
        got, tvalid = m["tm"].eval()(m["tc"])
    valid = np.asarray(jvalid)
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    assert got.shape == want.shape == (B, 1, m["jspec"].n_out)
    err = np.abs(got.numpy() - np.asarray(want))[valid]
    assert err.max() <= LOGIT_TOL, err.max()


def _jax_step(m, jbatch, jloss_cfg):
    """JAX's loss, logits, statistics and gradients of one train step, its
    dropout outputs, and its gradients, statistics and logits under a 1e-6
    relative weight perturbation (the same dropout key)."""
    jm, variables, jc = m["jm"], m["variables"], m["jc"]

    @jax.jit
    def jstep(params, batch_stats):
        def loss_fn(p):
            (logits, out_valid), mut = jm.apply(
                {"params": p, "batch_stats": batch_stats}, jc, train=True,
                bn_momentum=MOMENTUM, rngs={"dropout": jax.random.PRNGKey(3)},
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, _: isinstance(
                    mdl, jlayers.nn.Dropout))
            loss = _compute_loss(logits, out_valid, jbatch, jloss_cfg, None)
            return loss, (logits, mut["batch_stats"],
                          mut["intermediates"]["mlp"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (jl, (jlogits, jbs, drops)), jg = jstep(variables["params"],
                                            variables["batch_stats"])
    leaves, tdef = jax.tree_util.tree_flatten(variables["params"])
    noise = np.random.default_rng(9)
    shaken = jax.tree_util.tree_unflatten(tdef, [
        leaf * (1 + 1e-6 * noise.standard_normal(leaf.shape)).astype(
            np.float32) for leaf in leaves])
    (_, (slogits, sbs, _)), sg = jstep(shaken, variables["batch_stats"])
    return (jl, jlogits, jbs, jg, sbs, sg, slogits), drops


def test_options_train_step_matches_jax(model, monkeypatch):
    monkeypatch.setattr(jnb, "knn", _direct_3d)
    monkeypatch.setenv("CCN_SPLIT_EDGE", "force")
    monkeypatch.setattr(TNet, "_draws", staticmethod(_random_draws))
    m = model
    cfg = _cfg()
    cats = m["cats"]
    info = JT.task_for(cfg["dataset_source"], cfg["task"])
    jloss_cfg = jmain.dataclasses_replace_lovasz(info.loss_cfg, cfg)
    jbatch = JBatch(cloud=m["jc"], labels=jnp.asarray(cats),
                    categories=jnp.asarray(cats))
    j, drops = _jax_step(m, jbatch, jloss_cfg)
    names = sorted((k for k in drops if k.startswith("Dropout_")),
                   key=lambda s: int(s.split("_")[1]))
    # one drop after each hidden layer of the head and one before its last
    assert len(names) == len(m["jspec"].out_mlp_dims) + 1
    masks = [torch.from_numpy(np.asarray(drops[k]["__call__"][0]) != 0)
             for k in names]
    tm = m["tm"].train()
    tm.zero_grad()
    batch = Batch(cloud=m["tc"], labels=torch.from_numpy(cats),
                  categories=torch.from_numpy(cats))
    logits, out_valid = tm(m["tc"], train=True, bn_momentum=MOMENTUM,
                           dropout_masks=masks)
    loss = compute_loss(logits, out_valid, batch, TT.loss_for(cfg))
    loss.backward()
    _check_step(m["jspec"], tm, loss, logits, out_valid.numpy(), j)


def _counted(monkeypatch, sites):
    seen = {}
    for mod, fn, key in [(knn, "knn_search", "knn"), (fps, "fps_picks", "fps"),
                         (gather, "gather_km", "gather"),
                         (gather, "scatter_km", "scatter"),
                         (group_reduce, "group_reduce", "group_reduce"),
                         (group_train, "group_train_fwd", None)]:
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _key=key, **kw):
            if _key is None:
                sites.append(a[:4])
            else:
                seen[_key] = seen.get(_key, 0) + 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, fn, counted)
    return seen


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_options_launch_counts_follow_spec(train, monkeypatch):
    """One forward (eval) or train step of the narrow options model calls
    each wrapper as ``kernel_launches`` derives: K2 / K7 only where the
    step's aggregation and widths admit them, K3 for the 3-D dgcnn-rad
    ball but not for dgcnn's feature-space search, K6 for sa-geo on FPS
    but not for the random and curve-fps samplers."""
    _, tspec = _specs()
    n = 512
    sites = []
    seen = _counted(monkeypatch, sites)
    tm = TNet(tspec, n)
    predict.init_weights(tm, torch.Generator().manual_seed(0))
    pos, cid, valid, _, cats = synthetic_object_batch(
        np.random.default_rng(1), 2, n)
    tc = _clouds(pos, None, cid, valid)[1]
    if train:
        logits, _ = tm.train()(tc, train=True,
                               generator=torch.Generator().manual_seed(0))
        logits.sum().backward()
        fwd, bwd = _stand_in_launches(monkeypatch, sites)
        seen.update(group_train_fwd=fwd, group_train_bwd=bwd)
    else:
        with torch.no_grad():
            tm.eval()(tc)
    want = {k: v for k, v in kernel_launches(tspec, n, train=train).items()
            if v}
    assert seen == want


# the full-size launches a forward / a train step (none depend on the batch)
FULL_LAUNCHES = {
    ("options", False): {"group_reduce": 7, "gather": 5, "knn": 6, "fps": 2},
    ("options", True): {"group_train_fwd": 39, "group_train_bwd": 57,
                        "gather": 5, "scatter": 5, "knn": 6, "fps": 2},
    ("nuscenes_k1", False): {"conv1d_chain": 1, "group_reduce": 15,
                             "gather": 10, "knn": 9, "fps": 2},
}


@pytest.mark.parametrize("name,train", list(FULL_LAUNCHES))
def test_full_size_option_launch_counts(name, train):
    """At the published widths: the options model (dgcnn-rad's 3-D ball on
    K3; no K2 / K7 at the mean and weighted-sum steps, none in train at
    the one-layer curve-fps step; K6 at sa-geo and the FPS sa step), and
    nuScenes with step 0's ``kernel_size`` 1 (one K1 fewer)."""
    if name == "options":
        _, tspec = _specs(factor=None)
        n = 2048
    else:
        cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
        cfg["model"]["steps"][0]["kernel_size"] = 1
        tspec = tparse(cfg["model"], in_dim=predict.IN_DIM,
                       n_out=predict.N_OUT["nuscenes"])
        n = int(cfg["n_pad"])
        shipped = tparse(load_config(os.path.join(
            REPO, "configs", "nuscenes.yaml"))["model"], in_dim=predict.IN_DIM,
            n_out=predict.N_OUT["nuscenes"])
        base = kernel_launches(shipped, n)
        assert base["conv1d_chain"] == 2
    got = {k: v for k, v in kernel_launches(tspec, n, train=train).items()
           if v}
    assert got == FULL_LAUNCHES[(name, train)]


# ---------------------------------------------------------------------------
# head dropout
# ---------------------------------------------------------------------------

def test_head_dropout_matches_jax():
    """A head MLP (relu, plain last, dropout 0.5) in train: flax draws each
    ``nn.Dropout``'s mask; the port is fed them, read from the zero
    pattern of each Dropout's output (where the input is already 0 the
    mask does not matter)."""
    dims, p = (24, 32, 16, 5), 0.5
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 24)).astype(np.float32)
    valid = rng.random((3, 40)) > 0.2
    jm = jlayers.MLP(dims, dropout=p, use_bias=True)
    variables = random_variables(jm, jnp.asarray(x))

    def jfwd(params, xx):
        out, inter = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xx,
            mask=jnp.asarray(valid), train=True, bn_momentum=MOMENTUM,
            rngs={"dropout": jax.random.PRNGKey(3)},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(
                mdl, jlayers.nn.Dropout))
        return out, inter

    out, inter = jax.jit(jfwd)(variables["params"], jnp.asarray(x))
    drops = inter["intermediates"]
    names = sorted((k for k in drops if k.startswith("Dropout_")),
                   key=lambda s: int(s.split("_")[1]))
    assert len(names) == len(dims) - 1   # after each hidden act + last input
    masks = [torch.from_numpy(np.asarray(drops[k]["__call__"][0]) != 0)
             for k in names]
    jg = jax.jit(jax.grad(lambda pr: jnp.sum(
        jfwd(pr, jnp.asarray(x))[0] * _cotangent(out.shape, jnp))))(
        variables["params"])
    tm = tlayers.MLP(dims, dropout=p, use_bias=True)
    sd = tckpt.from_jax_variables({"mlp": variables["params"]},
                                  {"mlp": variables["batch_stats"]}, _NO_STEPS)
    tm.load_state_dict({k[len("mlp."):]: v for k, v in sd.items()})
    tx = torch.from_numpy(x)
    got = tm(tx, mask=torch.from_numpy(valid), train=True,
             bn_momentum=MOMENTUM, dropout_masks=masks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    (got * _cotangent(got.shape, torch)).sum().backward()
    want = tckpt.from_jax_variables({"mlp": jg}, {}, _NO_STEPS)
    _check_grads((("mlp." + k, q) for k, q in tm.named_parameters()), want)
    # drawn from a generator: about half kept, kept values doubled
    y = tm(tx, train=True, generator=torch.Generator().manual_seed(0))
    assert y.shape == got.shape and bool(torch.isfinite(y).all())
    with torch.no_grad():
        assert torch.equal(tm(tx), tm(tx, train=False))


_NO_STEPS = SimpleNamespace(steps=())   # the bridge maps a head "mlp"


# ---------------------------------------------------------------------------
# wandb
# ---------------------------------------------------------------------------

def test_metric_logger_without_wandb_falls_back(tmp_path, capsys):
    """``use_wandb=True`` with no wandb to import: one printed line, then
    the same JSONL records as JAX's logger."""
    loggers = [jlog.MetricLogger(str(tmp_path / "jax"), use_wandb=True),
               tlog.MetricLogger(str(tmp_path / "port"), use_wandb=True)]
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2 and printed[0] == printed[1]
    assert "wandb unavailable" in printed[1]
    for lg in loggers:
        lg.log({"loss": 1.5, "acc": np.float32(0.25)}, step=3)
        lg.close()
    recs = []
    for sub in ("jax", "port"):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            recs.append([{k: v for k, v in json.loads(line).items()
                          if k != "ts"} for line in f])
    assert recs[0] == recs[1] == [{"step": 3, "loss": 1.5, "acc": 0.25}]




def test_main_with_use_wandb_falls_back(tmp_path, capsys):
    """``main --use_wandb true --only_val true`` on the stand-in dataset
    (the tiny part-segmentation model of ``test_torch_port_main_train.py``;
    the classification loop's confusion figure waits for visualization/):
    the port prints the fallback line, runs to its end and writes the
    metrics.jsonl keys JAX's ``main`` writes on the same arguments (and
    the port's ``scan_wall_s``)."""
    weights = _weights(tmp_path, "segmentation")
    kw = dict(only_val=True, use_wandb=True)
    jmain.main(_main_cfg(tmp_path, "segmentation", "jax", weights, **kw))
    jax_out = capsys.readouterr().out
    score = tmain.main(_main_cfg(tmp_path, "segmentation", "port",
                                 weights, device="cpu", **kw))
    port_out = capsys.readouterr().out
    line = [s for s in jax_out.splitlines() if "wandb unavailable" in s]
    assert len(line) == 1
    assert [s for s in port_out.splitlines()
            if "wandb unavailable" in s] == line
    assert np.isfinite(score)
    keys = []
    for pkg in ("jax", "port"):
        with open(tmp_path / f"{pkg}-segmentation" / "metrics.jsonl") as f:
            keys.append([set(json.loads(r)) for r in f])
    # the port's segmentation loop adds its TTA scan wall (run/tasks.py)
    assert keys[0] and [k - {"scan_wall_s"} for k in keys[1]] == keys[0]


# ---------------------------------------------------------------------------
# the smoke's K7 slope-flip scan, on the CPU model of K7's residuals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aggr,a", [("attend", 16), ("max", 0)])
def test_smoke_flip_scan_bounds_flipped_inputs(aggr, a):
    """``chip_smoke._flip_scan`` on the residuals of the CPU model of K7
    (``test_torch_port_group_train_tc.model_fwd``: 3xTF32 products, its
    row list and stored values): every BN is scanned, the few rows that
    take the other slope than in float64 lie within ``FLIP_MULT`` 3xTF32
    roundings of 0 and pass ``check_flips``; stored level-1 values
    shifted by a fault flip rows far from 0, which it catches."""
    from test_torch_port_group_train_tc import _case, model_fwd

    cfg, h1, mask, params, dout = _case(aggr, 12, 64, (8, 16, 16), a, 0.6)
    _, stats, n, extras = model_fwd(h1, mask, cfg, params)
    assert extras[0].dtype == torch.int32
    scan = chip_smoke._flip_scan(h1, mask, cfg, params, stats, n, extras)
    assert sorted(scan) == list(range(cfg.n_bns))
    rows = extras[0].numel()
    for flips, elems, big, mult in scan.values():
        assert flips <= elems and mult <= chip_smoke.FLIP_MULT
    # the float64 fallback: the kernel's slopes in place of float64's
    # differ only where a row flips
    k_out, e_out = chip_smoke._bn_branches(h1, mask, cfg, params, stats, n,
                                           extras, dout)
    assert len(k_out) == len(e_out) == 1 + len(params)
    for got, want in zip(k_out, e_out):
        assert got.dtype == torch.float64 and bool(torch.isfinite(got).all())
        scale = max(float(want.norm()), 1e-12)
        assert float((got - want).norm()) / scale <= (
            0.0 if not any(f[0] for f in scan.values()) else 0.05)
    bad = list(extras)
    bad[5] = bad[5] + 0.3 * bad[5].std(0)      # v_1, as a faulty kernel's
    bad_scan = chip_smoke._flip_scan(h1, mask, cfg, params, stats, n,
                                     tuple(bad))
    flips, _, _, mult = bad_scan[1]
    assert flips > chip_smoke.FLIP_CAP * rows and mult > chip_smoke.FLIP_MULT
    with pytest.raises(AssertionError, match="3xTF32 roundings"):
        chip_smoke.check_flips("K7", cfg, bad_scan, rows)
    with pytest.raises(AssertionError, match="3xTF32 roundings"):
        chip_smoke._bn_branches(h1, mask, cfg, params, stats, n, tuple(bad),
                                dout)


@pytest.mark.parametrize("width,rows,elems,mult,every_width,raises", [
    (512, 10, 12, 1.0, False, None),           # within every cap
    (512, 11, 11, 1.0, False, "live rows"),    # past the row cap
    (512, 1, 1, 33.0, False, "3xTF32 roundings"),
    (1024, 14, 15, 1.0, False, None),          # within the element share
    (1024, 14, 15, 1.0, True, "live rows"),    # the fallback's row cap
    (1024, 14, 25, 1.0, False, "live elements"),
])
def test_smoke_check_flips_caps(width, rows, elems, mult, every_width,
                                raises):
    """``chip_smoke.check_flips`` over 10000 live rows: ``FLIP_CAP`` of
    the rows at a BN up to ``FLIP_CAP_WIDTH`` wide, and at every width on
    a call the float64 fallback holds; ``FLIP_CAP / FLIP_CAP_WIDTH`` of a
    wider BN's elements; ``FLIP_MULT`` roundings at every BN."""
    cfg = SimpleNamespace(n_loc=1, dims=(width,), att_dim=width)
    scan = {0: (rows, elems, 1e-6, mult)}
    if raises is None:
        chip_smoke.check_flips("K7", cfg, scan, 10000, every_width)
    else:
        with pytest.raises(AssertionError, match=raises):
            chip_smoke.check_flips("K7", cfg, scan, 10000, every_width)
