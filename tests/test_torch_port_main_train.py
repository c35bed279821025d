"""``main``'s epoch loop on the port against the JAX entry's on the CPU,
on the tiny object models of ``tests/test_driver_tasks.py``
(classification, and part segmentation without downsampling), both
packages starting from the same weights (a reference-format ``.pth``
each loads through its ``weights`` option):

* the learning rate of every optimizer step: the JAX run's schedule
  (``make_schedule``) at each of its steps, the port's as ``train_step``
  received it; the BatchNorm momentum of every epoch;
* the files under ``outdir``: the same ``epoch{E}``, ``latest``,
  ``latest_state.json`` and ``metrics.jsonl``; ``best_epoch{E}`` where the
  package's own val score rose (the scores differ: the sampling steps
  draw from a ``torch.Generator`` where JAX splits keys, DEVIATIONS #14);
  ``latest_state.json`` with the last epoch and the best score;
* a rerun to one more epoch resumes both at the saved epoch: the port's
  first step runs on the saved weights and optimizer state, at the
  schedule's rate of the saved step count;
* a finite score in [0, 1]; the epoch loop logs the previous step's loss
  every 10 steps.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from curvecloudnet_tpu import main as jmain
from curvecloudnet_tpu.data import loader as JL
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import main as tmain
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.predict import init_weights
from curvecloudnet_tpu_torch.run import tasks as TT
from test_driver_tasks import TINY_OBJ_MODEL

torch.set_num_threads(1)

SEG_MODEL = dict(TINY_OBJ_MODEL, steps=[
    dict(step_name="conv1d-fast-v2", with_diff=True, with_xyz=True,
         kernel_size=3, feat_dims=[8, 8]),
    dict(step_name="mlp", plain_last=False, with_xyz=True,
         feat_dims=[16, 8]),
    dict(step_name="sgcnn", with_xyz=True, knn=4, use_sparse_feat_agg=True,
         feat_dims=[8, 8]),
    dict(step_name="skip-connect", num_skips=1, feat_dims=[16, 16]),
])
MODELS = {"classification": TINY_OBJ_MODEL, "segmentation": SEG_MODEL}


def _weights(tmp_path, task):
    """The same random weights for both packages, as a reference .pth."""
    info = TT.task_for("synthetic-objects", task)
    spec = tparse(MODELS[task], in_dim=3, n_out=info.n_out)
    model = TNet(spec, 48)
    init_weights(model, torch.Generator().manual_seed(5))
    path = str(tmp_path / f"{task}.pth")
    torch.save(model.state_dict(), path)
    return path


def _cfg(tmp_path, task, pkg, weights, **extra):
    return dict(dict(dataset_source="synthetic-objects", task=task,
                     outdir=str(tmp_path / f"{pkg}-{task}"), batch_size=4,
                     n_pad=48, n_train=12, n_val=8, lr=1e-3, epochs=2,
                     val_every=1, save_every=2, eval_batch_size=4,
                     model=MODELS[task], weights=weights, num_workers=1,
                     bn_momentum_decay=0.5,
                     scheduler={"name": "exp", "lr_gamma": 0.5}), **extra)


class Spies:
    """What each package's loop did: the JAX schedule and its train steps
    an epoch, each epoch's BN momentum; the port's (lr, momentum) a step and
    the weights and optimizer state its first step started from."""

    def __init__(self, monkeypatch):
        self.jax_sched, self.jax_steps, self.jax_bn = None, [], []
        self.port = []
        self.first = None
        make_schedule, bn_for = jmain.make_schedule, jmain.bn_momentum_for_epoch
        epoch = JL.PrefetchLoader.epoch
        step = tmain.train_step

        def sched(*a, **kw):
            self.jax_sched = make_schedule(*a, **kw)
            return self.jax_sched

        def bn(epoch_, *a, **kw):
            self.jax_bn.append((epoch_, bn_for(epoch_, *a, **kw)))
            return self.jax_bn[-1][1]

        def batches(loader, epoch_=0):
            if not loader.shuffle:       # an eval loop's loader
                yield from epoch(loader, epoch_)
                return
            self.jax_steps.append(0)
            for b in epoch(loader, epoch_):
                self.jax_steps[-1] += 1
                yield b

        def train_step(model, opt, lr, batch, generator, bn_momentum,
                       loss_cfg):
            if self.first is None:
                self.first = (copy.deepcopy(model.state_dict()),
                              copy.deepcopy(opt.state_dict()))
            self.port.append((lr, bn_momentum))
            return step(model, opt, lr, batch, generator, bn_momentum,
                        loss_cfg)

        monkeypatch.setattr(jmain, "make_schedule", sched)
        monkeypatch.setattr(jmain, "bn_momentum_for_epoch", bn)
        monkeypatch.setattr(JL.PrefetchLoader, "epoch", batches)
        monkeypatch.setattr(tmain, "train_step", train_step)


def _scores(outdir):
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [(r["epoch"], r["score"]) for r in lines if "score" in r]


def _check_files(outdir, scores):
    """Checkpoints and latest_state.json of a run's own scores."""
    best, names = -1e30, set()
    for epoch, score in scores:
        if score > best:
            best = score
            names.add(f"best_epoch{epoch}")
    got = {n for n in os.listdir(outdir) if n.startswith("best_epoch")}
    assert got == names
    with open(os.path.join(outdir, "latest_state.json")) as f:
        state = json.load(f)
    assert state == {"epoch": scores[-1][0], "max_score": best}
    return {n for n in os.listdir(outdir) if not n.startswith("best_epoch")}


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    """fn(task) -> (spies, JAX config, port config, (JAX score, port
    score)): both packages' 2-epoch runs of a task from the same weights,
    run once a module."""
    runs = {}

    def run(task):
        if task not in runs:
            tmp = tmp_path_factory.mktemp(task)
            weights = _weights(tmp, task)
            jcfg = _cfg(tmp, task, "jax", weights)
            tcfg = _cfg(tmp, task, "port", weights, device="cpu")
            with pytest.MonkeyPatch.context() as mp:
                spies = Spies(mp)
                scores = jmain.main(jcfg), tmain.main(tcfg)
            runs[task] = spies, jcfg, tcfg, scores
        return runs[task]

    return run


@pytest.mark.parametrize("task", ["classification", "segmentation"])
def test_epoch_loop_matches_jax_main(task, two_epochs):
    spies, jcfg, tcfg, (jscore, tscore) = two_epochs(task)
    for score in (jscore, tscore):
        assert np.isfinite(score) and 0.0 <= score <= 1.0
    # 12 samples, batches of 4: 3 steps an epoch, the rate halved an epoch
    assert spies.jax_steps == [3, 3]
    want = [float(spies.jax_sched(s)) for s in range(6)]
    np.testing.assert_allclose([lr for lr, _ in spies.port], want,
                               rtol=1e-6)
    np.testing.assert_allclose(want[::3], [1e-3, 5e-4], rtol=1e-6)
    jbn = [m for _, m in spies.jax_bn]
    assert [m for _, m in spies.port] == [jbn[0]] * 3 + [jbn[1]] * 3
    assert jbn == [0.1, 0.05]
    # the same files; best_epoch where each package's own score rose
    jfiles = _check_files(jcfg["outdir"], _scores(jcfg["outdir"]))
    tfiles = _check_files(tcfg["outdir"], _scores(tcfg["outdir"]))
    assert jfiles == tfiles == {"epoch1", "latest", "latest_state.json",
                                "metrics.jsonl"}
    assert tscore == max(s for _, s in _scores(tcfg["outdir"]))


def test_resume_restores_epoch_weights_and_optimizer(tmp_path, two_epochs,
                                                     monkeypatch):
    # copies of the 2-epoch runs' outdirs, rerun here
    _, jcfg0, tcfg0, _ = two_epochs("classification")
    jcfg = dict(jcfg0, outdir=str(tmp_path / "jax"))
    tcfg = dict(tcfg0, outdir=str(tmp_path / "port"))
    shutil.copytree(jcfg0["outdir"], jcfg["outdir"])
    shutil.copytree(tcfg0["outdir"], tcfg["outdir"])
    spies = Spies(monkeypatch)
    outdir = tcfg["outdir"]
    saved = torch.load(os.path.join(outdir, "latest", tckpt.CHECKPOINT_FILE),
                       weights_only=True)
    assert saved["step"] == 6
    # a rerun to a third epoch: weights= is left out (it would restart),
    # both resume from outdir's latest
    jmain.main(dict(jcfg, epochs=3, weights=""))
    tscore = tmain.main(dict(tcfg, epochs=3, weights=""))
    assert [e for e, _ in spies.jax_bn] == [2]
    assert spies.jax_steps == [3] and len(spies.port) == 3
    assert spies.port[0][0] == pytest.approx(float(spies.jax_sched(6)),
                                             rel=1e-6)
    assert spies.port[0][1] == spies.jax_bn[0][1] == 0.025
    model_sd, opt_sd = spies.first
    for k, v in saved["model"].items():
        assert torch.equal(model_sd[k], v), k
    assert opt_sd["param_groups"] == saved["optimizer"]["param_groups"]
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(opt_sd["state"][i][k], v), (i, k)
    with open(os.path.join(outdir, "latest_state.json")) as f:
        assert json.load(f)["epoch"] == 2
    assert np.isfinite(tscore)
    assert "epoch2" not in os.listdir(outdir)   # save_every 2: epoch 1, 3


def test_epoch_loop_logs_the_previous_steps_loss(tmp_path):
    """Every 10 steps the loop logs the loss of the step before (its copy
    started without blocking), and each epoch's line holds the mean."""
    task = "classification"
    cfg = _cfg(tmp_path, task, "port", "", device="cpu", n_train=44,
               epochs=1, val_every=5)
    tmain.main(cfg)
    with open(os.path.join(cfg["outdir"], "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    logged = [r for r in lines if "train_loss" in r]
    assert [r["step"] for r in logged] == [9]
    assert np.isfinite(logged[0]["train_loss"])
    assert not any("score" in r for r in lines)
