"""The port's entry point, data layer, writers and object loops against
the JAX package on the CPU.

* data: ``SyntheticLidarSeg`` / ``SyntheticObjects`` samples,
  ``pad_sample``, ``batch_iterator`` (shuffled and augmented too) and
  ``to_device_batch`` fields equal to JAX's; ``PrefetchLoader`` gives
  JAX's batches in JAX's per-epoch order, stays within ``prefetch``
  batches of its consumer, raises a worker's exception in the consumer,
  and refuses more than one process;
* the registry: ``task_for`` on every dataset source gives JAX's task;
* the writers: ``dump_submission`` files byte-equal to JAX's in both
  formats; ``parse_args`` / ``set_dotted`` equal on a list of argv cases;
  ``MetricLogger`` lines and ``median_top_k`` equal; ``latest_state.json``
  read across both packages; a native checkpoint round trip gives equal
  logits;
* the object loops on the narrow (widths / 8) shapenet-seg and
  shapenet-class models: ``evaluate_part_segmentation`` and, through
  ``main.run_eval``, ``evaluate_classification`` against JAX's (logits
  2e-3; scores equal unless an argmax is a near-tie);
* the entry point: ``main.main`` with ``only_val`` returns the score of
  ``run_eval`` on the model it builds, with ``use_wandb`` too (no wandb
  to import: JSONL alone); more than one process without an address, an
  empty dataset split and a missing card raise; the classification loop
  logs its confusion figure (the epoch loop:
  ``test_torch_port_main_train.py``; reading dataset files:
  ``test_torch_port_data*.py``; ``only_viz``: ``test_torch_port_viz.py``).
"""

import os
import re
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu import checkpoint as jckpt
from curvecloudnet_tpu import config as jconfig
from curvecloudnet_tpu import logging_utils as jlog
from curvecloudnet_tpu import main as jmain
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.data import datasets as JD
from curvecloudnet_tpu.data import loader as JL
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import neighbors as jnb
from curvecloudnet_tpu.run import metrics as JM
from curvecloudnet_tpu.run import tasks as JT
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import config as tconfig
from curvecloudnet_tpu_torch import logging_utils as tlog
from curvecloudnet_tpu_torch import main as tmain
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.data import datasets as TD
from curvecloudnet_tpu_torch.data import loader as TL
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.run import tasks as TT
from test_torch_port_eval import (LOGIT_TOL, QUIET, TIE_MARGIN, KeyNone,
                                  _near_ties, _spy, random_variables)
from torch_port_utils import direct_knn

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    return os.path.join(REPO, "configs", f"{name}.yaml")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

DATASETS = [
    ("SyntheticLidarSeg", dict(n_samples=5, n_pad=768, seed=2)),
    ("SyntheticLidarSeg", dict(n_samples=3, n_pad=512, n_classes=20,
                               n_beams=64, seed=1)),
    ("SyntheticObjects", dict(n_samples=5, n_pad=256, task="segmentation",
                              seed=2)),
    ("SyntheticObjects", dict(n_samples=5, n_pad=256,
                              task="classification", seed=1)),
]


def _same_batch(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("cls,kw", DATASETS)
def test_datasets_match_jax(cls, kw):
    jds, tds = getattr(JD, cls)(**kw), getattr(TD, cls)(**kw)
    assert (len(tds), tds.n_pad, tds.in_dim, tds.n_classes, tds.task,
            tds.ignore_index) == (len(jds), jds.n_pad, jds.in_dim,
                                  jds.n_classes, jds.task, jds.ignore_index)
    for i in range(len(jds)):
        a, b = jds.get(i), tds.get(i)
        _same_batch(TD.pad_sample(b, kw["n_pad"]),
                    JD.pad_sample(a, kw["n_pad"]))
        if cls == "SyntheticLidarSeg":
            assert 0.85 * kw["n_pad"] <= len(b.pos) <= kw["n_pad"]
    for it_kw in (dict(drop_last=False),
                  dict(shuffle=True, augment=True, seed=3)):
        for want, got in zip(JD.batch_iterator(jds, 2, **it_kw),
                             TD.batch_iterator(tds, 2, **it_kw)):
            _same_batch(got, want)
            jb = JD.to_device_batch(dict(want), jds.task)
            tb = TD.to_device_batch(dict(got), tds.task, "cpu")
            pairs = [(jb.cloud.pos, tb.cloud.pos),
                     (jb.cloud.valid, tb.cloud.valid),
                     (jb.cloud.curve_id, tb.cloud.curve_id),
                     (jb.labels, tb.labels),
                     (jb.categories, tb.categories)]
            if jb.cloud.x is not None:
                pairs.append((jb.cloud.x, tb.cloud.x))
            else:
                assert tb.cloud.x is None
            for j, t in pairs:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
                assert t.numpy().dtype == np.asarray(j).dtype


def test_loader_order_and_shuffle_match_jax():
    kw = dict(n_samples=13, n_pad=64, task="classification")
    jds, tds = JD.SyntheticObjects(**kw), TD.SyntheticObjects(**kw)
    for lkw in (dict(shuffle=False, drop_last=False),
                dict(shuffle=True, seed=7, drop_last=True)):
        jl = JL.PrefetchLoader(jds, 4, num_workers=3, **lkw)
        tl = TL.PrefetchLoader(tds, 4, num_workers=3, **lkw)
        assert len(tl) == len(jl)
        for epoch in (0, 1):
            got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _same_batch(g, w)
    # unshuffled: the sequential batcher's batches
    for g, w in zip(TL.PrefetchLoader(tds, 4, drop_last=False).epoch(0),
                    TD.batch_iterator(tds, 4, drop_last=False)):
        _same_batch(g, w)


class _Counting(TD.SyntheticObjects):
    def __init__(self, fail_at=None, **kw):
        super().__init__(**kw)
        self.fail_at, self.calls = fail_at, 0
        self.lock = threading.Lock()

    def get(self, idx, rng=None, augment=False):
        with self.lock:
            self.calls += 1
        if idx == self.fail_at:
            raise ValueError(f"sample {idx} is broken")
        return super().get(idx, rng, augment)


def test_loader_bounds_prefetch_and_raises_worker_errors(monkeypatch):
    ds = _Counting(n_samples=40, n_pad=32, task="classification")
    it = TL.PrefetchLoader(ds, 2, num_workers=3, prefetch=2).epoch(0)
    next(it)
    time.sleep(0.3)
    # taken by the workers: the consumed batch and at most `prefetch` more
    assert ds.calls <= 2 * (1 + 2)
    assert len(list(it)) == 19
    bad = _Counting(fail_at=5, n_samples=12, n_pad=32, task="classification")
    with pytest.raises(ValueError, match="sample 5 is broken"):
        list(TL.PrefetchLoader(bad, 2, num_workers=2).epoch(0))
    # more than one process: each reads its lockstep shard of the JAX
    # loader's order (process 1 of 2: 20 of the 40 items)
    import jax

    from curvecloudnet_tpu_torch.parallel import mesh as tmesh

    for mod in (tmesh, jax):
        monkeypatch.setattr(mod, "process_count", lambda: 2)
        monkeypatch.setattr(mod, "process_index", lambda: 1)
    assert len(list(TL.PrefetchLoader(ds, 2).epoch(0))) == 10
    want = [list(b) for b in
            JL.PrefetchLoader(ds, 2, shuffle=True)._batch_indices(3)]
    assert [list(b) for b in TL.PrefetchLoader(
        ds, 2, shuffle=True)._batch_indices(3)] == want
    assert len(list(TL.PrefetchLoader(ds, 2, shard_by_process=False)
                    .epoch(0))) == 20


# ---------------------------------------------------------------------------
# the registry and the writers
# ---------------------------------------------------------------------------

SOURCES = [("nuscenes", "segmentation"), ("kitti", "segmentation"),
           ("audi", "segmentation"), ("shapenet-seg", "segmentation"),
           ("shapenet-seg", "classification"), ("shapenet", "segmentation"),
           ("shapenet", "classification"), ("kortx", "segmentation"),
           ("summer-robotics", "segmentation"),
           ("synthetic-lidar", "segmentation"),
           ("synthetic-objects", "segmentation"),
           ("synthetic-objects", "classification")]


@pytest.mark.parametrize("source,task", SOURCES)
def test_task_for_matches_jax(source, task):
    want, got = JT.task_for(source, task), TT.task_for(source, task)
    for field in ("name", "task", "n_out", "class_names", "tta",
                  "metric_ignore", "part_iou"):
        assert getattr(got, field) == getattr(want, field), field
    if want.class_weights is None:
        assert got.class_weights is None
    else:
        np.testing.assert_array_equal(got.class_weights, want.class_weights)
    for field in ("task", "ignore_index", "use_lovasz", "lovasz_weight",
                  "mean_over_all"):
        assert getattr(got.loss_cfg, field) == \
            getattr(want.loss_cfg, field), field
    assert got.n_out == predict.N_OUT.get(got.name, got.n_out)


def test_task_for_unknown_source_raises():
    for fn in (JT.task_for, TT.task_for):
        with pytest.raises(KeyError):
            fn("modelnet", "classification")


def test_dump_submission_matches_jax(tmp_path):
    n, c = 40, 17
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, n, c)).astype(np.float32)
    valid = np.ones((2, n), bool)
    valid[1, 30:] = False
    metas = [{"format": "nuscenes", "fname": "tok_lidarseg.bin",
              "reorder": rng.permutation(n)},
             {"format": "kitti",
              "fpath": os.path.join("seqs", "11", "velodyne", "000042.bin")},
             None]
    logits3 = np.concatenate([logits, logits[:1]])
    valid3 = np.concatenate([valid, valid[:1]])
    JT.dump_submission(jnp.asarray(logits3), jnp.asarray(valid3), metas,
                       str(tmp_path / "jax"))
    TT.dump_submission(torch.from_numpy(logits3), torch.from_numpy(valid3),
                       metas, str(tmp_path / "port"))
    files = [os.path.join("results", "lidarseg", "test", "tok_lidarseg.bin"),
             os.path.join("method_predictions", "sequences", "11",
                          "predictions", "000042.label")]
    for f in files:
        want = (tmp_path / "jax" / f).read_bytes()
        assert (tmp_path / "port" / f).read_bytes() == want
        assert len(want) in (n, 30 * 4)


ARGV = [
    ["--only_val=true", "--n_val", "2"],
    ["--lr=0.01", "--epochs", "3", "--scheduler.lr_gamma=0.5"],
    ["--model.steps=[1, 2]", "--use_tta=False", "stray", "--outdir=/tmp/x"],
    ["--only_test", "1", "--weights=w.pth", "--nope.deeper=3"],
    ["--device=cpu", "--tta_views_per_call=4"],
]


@pytest.mark.parametrize("argv", ARGV)
def test_parse_args_matches_jax(argv):
    args = ["--config", _config("nuscenes")] + argv
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jconfig.parse_args(args)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tconfig.parse_args(args)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert got.pop("device") == want.pop("device", "cuda")
    assert got == want
    assert tconfig.config_summary(got) == jconfig.config_summary(want)


def test_set_dotted_coerces_as_jax():
    base = {"a": {"b": 1, "f": 0.5, "t": True, "l": [1]}, "s": "x"}
    cases = [("a.b", "7"), ("a.f", "2"), ("a.t", "no"), ("a.l", "[3, 4]"),
             ("s", "y"), ("a.new", "{'k': 1}"), ("q.r", "1")]
    for path, value in cases:
        j, t = dict(base, a=dict(base["a"])), dict(base, a=dict(base["a"]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jconfig.set_dotted(j, path, value)
            tconfig.set_dotted(t, path, value)
        assert t == j, path
    with pytest.raises(ValueError):
        tconfig.set_dotted(dict(base, a=dict(base["a"])), "a.t", "maybe")


def test_metric_logger_matches_jax(tmp_path):
    entries = [({"score": 0.5, "epoch": 0, "name": "a"}, 1),
               ({"score": 0.7, "epoch": 1}, 2), ({"score": 0.6}, None),
               ({"score": np.float32(0.9), "loss": 1.5}, 4)]
    loggers = [jlog.MetricLogger(str(tmp_path / "jax")),
               tlog.MetricLogger(str(tmp_path / "port"))]
    for metrics, step in entries:
        for lg in loggers:
            lg.log(dict(metrics), step=step)
    for lg in loggers:
        lg.close()
    lines = []
    for sub in ("jax", "port"):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            recs = [__import__("json").loads(line) for line in f]
        lines.append([{k: v for k, v in r.items() if k != "ts"}
                      for r in recs])
    assert lines[1] == lines[0]
    j2, t2 = (jlog.MetricLogger(str(tmp_path / "jax")),
              tlog.MetricLogger(str(tmp_path / "port")))
    for lg in (j2, t2):
        lg.reload_history()
    for k in (1, 3, 5):
        assert t2.median_top_k("score", k) == j2.median_top_k("score", k)
    assert t2.summary_max == j2.summary_max
    assert np.isnan(t2.median_top_k("absent"))
    # wandb asked for and not importable: JSONL alone, as JAX's logger
    w = tlog.MetricLogger(str(tmp_path / "w"), use_wandb=True)
    w.log({"score": 0.5}, step=1)
    w.close()
    assert w._wandb is None
    assert (tmp_path / "w" / "metrics.jsonl").read_text().count("\n") == 1


def test_latest_state_read_across_packages(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    tckpt.dump_latest_state(str(a), 4, 0.625)
    jckpt.dump_latest_state(str(b), 7, 0.25)
    assert jckpt.read_latest_state(str(a)) == {"epoch": 4, "max_score": 0.625}
    assert tckpt.read_latest_state(str(b)) == {"epoch": 7, "max_score": 0.25}
    assert (a / "latest_state.json").read_text() == \
        (tmp_path / "b" / "latest_state.json").read_text().replace(
            "7", "4").replace("0.25", "0.625")
    assert tckpt.read_latest_state(str(tmp_path)) is None
    assert not tckpt.has_latest(str(a))


def _narrow_cfg(name, tmp_path, **extra):
    cfg = tconfig.load_config(_config(name))
    cfg["model"] = _shrink_feat_dims(cfg["model"], 8)
    cfg.update(device="cpu", outdir=str(tmp_path / name), **extra)
    return cfg


def test_checkpoint_round_trip(tmp_path):
    cfg = _narrow_cfg("shapenet-seg", tmp_path, n_pad=256, seed=3)
    _, val_ds, model = tmain.build(cfg)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tckpt.save_checkpoint(cfg["outdir"], "latest", model, opt, step=11)
    assert tckpt.has_latest(cfg["outdir"])
    np_batch = next(TD.batch_iterator(val_ds, 2))
    batch = TD.to_device_batch(np_batch, "segmentation", "cpu")
    with torch.no_grad():
        want, _ = model(batch.cloud, batch.categories)
    # a fresh build resumes from outdir's latest (another seed otherwise)
    _, _, back = tmain.build(dict(cfg, seed=4))
    opt2 = torch.optim.Adam(back.parameters(), lr=1e-3)
    assert tckpt.restore_checkpoint(cfg["outdir"], "latest", back,
                                    opt2) == 11
    assert opt2.state_dict()["param_groups"] == opt.state_dict()[
        "param_groups"]
    with torch.no_grad():
        got, _ = back(batch.cloud, batch.categories)
    assert torch.equal(got, want)
    # and through weights=<dir>/<name>
    _, _, named = tmain.build(dict(cfg, seed=5, outdir=str(tmp_path / "x"),
                                   weights=os.path.join(cfg["outdir"],
                                                        "latest")))
    with torch.no_grad():
        assert torch.equal(named(batch.cloud, batch.categories)[0], want)


# ---------------------------------------------------------------------------
# the object loops and run_eval
# ---------------------------------------------------------------------------

def _object_models(name, n_pad, task):
    """(JAX model, its variables, the port model, JAX val set, port val
    set) of a narrow (widths / 8) object config."""
    cfg = load_config(_config(name))
    mc = _shrink_feat_dims(cfg["model"], 8)
    n_out = predict.N_OUT[predict.task_of(cfg)]
    jspec = jparse(mc, in_dim=3, n_out=n_out)
    ds_j = JD.SyntheticObjects(n_samples=6, n_pad=n_pad, task=task, seed=2)
    ds_t = TD.SyntheticObjects(n_samples=6, n_pad=n_pad, task=task, seed=2)
    jb = JD.to_device_batch(next(JD.batch_iterator(ds_j, 2)), task)
    jm = JNet(jspec, n_points=n_pad)
    cats = jb.categories if jspec.with_seg_category else None
    variables = random_variables(jm, jb.cloud, cats)
    tm = TNet(tparse(mc, in_dim=3, n_out=n_out), n_pad)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    return jm, variables, tm.eval(), ds_j, ds_t


def _logit_spy(monkeypatch):
    spied = {"jax": [], "port": []}
    _spy(monkeypatch, JT, "make_tta_eval", spied["jax"])
    _spy(monkeypatch, TT, "make_tta_eval", spied["port"])
    return spied


def _same_logits(spied, batches):
    assert len(spied["jax"]) == len(spied["port"]) == batches
    for (_, jout), (_, tout) in zip(spied["jax"], spied["port"]):
        valid = np.asarray(jout[1])
        np.testing.assert_array_equal(tout[1].numpy(), valid)
        err = np.abs(tout[0].numpy() - np.asarray(jout[0]))[valid]
        assert err.max() <= LOGIT_TOL, err.max()


def test_evaluate_part_segmentation_matches_jax(monkeypatch):
    monkeypatch.setattr(jnb, "knn", direct_knn)
    jm, variables, tm, ds_j, ds_t = _object_models("shapenet-seg", 512,
                                                   "segmentation")
    spied = _logit_spy(monkeypatch)
    want = JT.evaluate_part_segmentation(KeyNone(jm), variables, ds_j,
                                         JT.TASKS["shapenet-seg"],
                                         batch_size=4, **QUIET)
    got = TT.evaluate_part_segmentation(tm, ds_t, TT.TASKS["shapenet-seg"],
                                        batch_size=4, **QUIET)
    _same_logits(spied, 2)
    assert got.keys() == want.keys()
    labels = [b["labels"] for b in TD.batch_iterator(ds_t, 4,
                                                     drop_last=False)]
    # each loop's scores are JAX's metric of its own logits, exactly
    assert want == _part_scores(spied["jax"], 4, labels)
    assert got == _part_scores(spied["port"], 3, labels)
    # and the two agree exactly once the points whose JAX part argmax is a
    # near-tie (top-two margin under TIE_MARGIN) are taken out
    cat_parts = list(JT.G.SHAPENET_SEG_CLASSES.values())
    ties = []
    for args, out in spied["jax"]:
        logits = np.asarray(out[0])
        ties.append([])
        for k, cat in enumerate(np.asarray(args[4])):
            top2 = np.sort(logits[k][:, cat_parts[int(cat)]], -1)[:, -2:]
            ties[-1].append(top2[:, 1] - top2[:, 0] < TIE_MARGIN)
    assert _part_scores(spied["port"], 3, labels, ties) == \
        _part_scores(spied["jax"], 4, labels, ties)


def _part_scores(spied, cat_at, labels, drop=None):
    """The part loop's scores, by JAX's metric, from the spied forwards'
    logits (categories at ``args[cat_at]``), with the points of ``drop``
    (per batch, per cloud) left out."""
    cat_parts = list(JT.G.SHAPENET_SEG_CLASSES.values())
    per_cat, inst = {}, []
    for bi, ((args, out), lab) in enumerate(zip(spied, labels)):
        logits, valid = np.asarray(out[0]), np.asarray(out[1])
        for k, cat in enumerate(np.asarray(args[cat_at])):
            parts = np.asarray(cat_parts[int(cat)])
            pred = parts[np.argmax(logits[k][:, parts], axis=-1)]
            keep = valid[k] if drop is None else valid[k] & ~drop[bi][k]
            iou = JM.part_iou_shapenet(pred, lab[k], keep, parts)
            inst.append(iou)
            per_cat.setdefault(int(cat), []).append(iou)
    return {"instance_miou": float(np.mean(inst)),
            "category_miou": float(np.mean([np.mean(v)
                                            for v in per_cat.values()]))}


def test_run_eval_classification_matches_jax(monkeypatch):
    """``main.run_eval`` of both packages (the classification loop)."""
    monkeypatch.setattr(jnb, "knn", direct_knn)
    jm, variables, tm, ds_j, ds_t = _object_models("shapenet-class", 512,
                                                   "classification")
    spied = _logit_spy(monkeypatch)
    cfg = {"eval_batch_size": 4}
    want = jmain.run_eval(KeyNone(jm), variables, ds_j,
                          JT.task_for("shapenet-seg", "classification"),
                          cfg, log=lambda *a: None)
    got = tmain.run_eval(tm, ds_t,
                         TT.task_for("shapenet-seg", "classification"), cfg,
                         **QUIET)
    _same_logits(spied, 2)
    assert got.keys() == want.keys()
    jlogits = np.concatenate([np.asarray(o[0])[:, 0] for _, o in spied["jax"]])
    ties = _near_ties(jlogits, np.ones(len(jlogits), bool))
    moved = np.abs(np.asarray(got["confmat"]) -
                   np.asarray(want["confmat"])).sum()
    assert moved <= 2 * ties
    if not ties:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tmain.score_of(got) == got["accuracy"]


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,extra", [
    ("shapenet-class", dict(n_pad=256, n_val=4, eval_batch_size=2)),
    ("nuscenes", dict(n_pad=512, n_val=1)),
])
def test_main_only_val_returns_run_eval(name, extra, tmp_path):
    cfg = _narrow_cfg(name, tmp_path, only_val=True, **extra)
    score = tmain.main(cfg)
    info, val_ds, model = tmain.build(dict(cfg, outdir=str(tmp_path / "b")))
    result = tmain.run_eval(model, val_ds, info, cfg, **QUIET)
    assert np.isfinite(score)
    assert score == tmain.score_of(result)
    with open(os.path.join(cfg["outdir"], "metrics.jsonl")) as f:
        logged = [__import__("json").loads(line) for line in f]
    assert logged[-1][{"shapenet-class": "accuracy",
                       "nuscenes": "miou"}[name]] == score
    if name == "nuscenes":
        assert "overflow" in result and result["class_names"][0] == "barrier"


def test_main_raises(tmp_path, monkeypatch):
    cfg = _narrow_cfg("shapenet-class", tmp_path, n_pad=128, n_val=2)
    with pytest.raises(ValueError, match="coordinator_address"):
        tmain.main(dict(cfg, only_val=True,
                        distributed={"num_processes": 2}))
    # wandb is not installed: main goes on with metrics.jsonl alone
    assert np.isfinite(tmain.main(dict(cfg, only_val=True, use_wandb=True)))
    # an existing but empty KITTI root: the split raises, naming its glob
    kitti = dict(tconfig.load_config(_config("kitti")),
                 data_path=str(tmp_path))
    with pytest.raises(FileNotFoundError, match=re.escape(os.path.join(
            "sequences", "{00,01,02,03,04,05,06,07,09,10}", "velodyne",
            "*.bin"))):
        tmain.load_datasets(kitti)
    with pytest.raises(KeyError):
        tmain.load_datasets(dict(cfg, dataset_source="modelnet"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(dict(cfg, only_val=True, device="cuda"))
    assert tconfig.parse_args(["--config", _config("kitti")])["device"] == \
        "cuda"
    _, val_ds, model = tmain.build(cfg)
    logger = tlog.MetricLogger(str(tmp_path / "media_run"))
    TT.evaluate_classification(model, val_ds, TT.TASKS["shapenet-class"],
                               media_logger=logger, **QUIET)
    logger.close()
    assert os.path.exists(tmp_path / "media_run" / "media" /
                          "eval_confusion.png")


def test_load_datasets_match_jax():
    """The synthetic stand-ins of every config: JAX's sizes, seeds, classes
    and beams (32 for every lidar dataset)."""
    for name in ("nuscenes", "kitti", "audi", "shapenet-seg",
                 "shapenet-class", "kortx-testsplit"):
        cfg = dict(tconfig.load_config(_config(name)), n_train=3, n_val=2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jmain.load_datasets(cfg)
        got = tmain.load_datasets(cfg)
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__
            assert vars(g) == vars(w)
