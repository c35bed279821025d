"""``main`` and the tools of the port on dataset files against the JAX
entry's, on the CPU (fixtures of ``curvecloudnet_tpu_torch/tools/
fake_datasets.py``, frames of a few hundred points, the tiny models of
``tests/test_torch_port_main_train.py``, both packages starting from the
same weights: JAX variables drawn with numpy, carried to a reference
``.pth`` by ``checkpoint.from_jax_variables``):

* training from files: nuScenes (PolarMix on) and shapenet-seg, one epoch
  of two steps through ``main`` each: the batches each package's loop
  trains on bit-equal (one loader worker), the learning rate of every
  step, the epoch's BN momentum and the files under ``outdir``, as the
  epoch-loop test holds them;
* ``--only_test`` on the KITTI and nuScenes fixtures: the submission files
  byte-equal to JAX's, one prediction a point of each frame;
* the tools: ``calibrate --device cpu`` (its report and exit code) and
  ``budget_audit`` on the narrow nuScenes config (widths / 8), and
  ``convert_checkpoint``, whose native checkpoint gives ``main --weights``
  the logits of the ``.pth``.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu import main as jmain
from curvecloudnet_tpu.data import datasets as JD
from curvecloudnet_tpu.data import loader as JLD
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import neighbors as jnb
from curvecloudnet_tpu.run import tasks as JT
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import config as tconfig
from curvecloudnet_tpu_torch import main as tmain
from curvecloudnet_tpu_torch.data import datasets as TD
from curvecloudnet_tpu_torch.data import loader as TLD
from curvecloudnet_tpu_torch.run.globals import KITTI_LEARNING_MAP_INV
from curvecloudnet_tpu_torch.tools import budget_audit, calibrate
from curvecloudnet_tpu_torch.tools import convert_checkpoint
from curvecloudnet_tpu_torch.tools import fake_datasets as F
from test_torch_port_eval import random_variables
from test_torch_port_main_train import SEG_MODEL, Spies
from torch_port_utils import direct_knn

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = (300, 600)
N_PAD = 768
FRAMES = {"train": 4, "val": 2, "test": 2}
KITTI_RAW_IDS = KITTI_LEARNING_MAP_INV.values()


def _config(name):
    return tconfig.load_config(os.path.join(REPO, "configs", f"{name}.yaml"))


def _write(name, root):
    cfg = _config(name)
    frames = FRAMES if cfg["dataset_source"] in ("kitti", "nuscenes") else \
        {"train": 4, "val": 2}
    return F.write_for_config(cfg, root, frames,
                              96 if name == "shapenet-seg" else POINTS, 7)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """fn(name) -> (data_path, .pth weights of the tiny seg model), written
    once a module."""
    made = {}

    def get(name):
        if name not in made:
            tmp = tmp_path_factory.mktemp(name)
            root = _write(name, str(tmp / "data"))
            cfg = dict(_config(name), data_path=root, n_pad=N_PAD)
            train, _ = jmain.load_datasets(cfg)
            info = JT.task_for(cfg["dataset_source"], cfg["task"])
            spec = jparse(SEG_MODEL, in_dim=train.in_dim, n_out=info.n_out)
            jb = JD.to_device_batch(next(JD.batch_iterator(train, 1)),
                                    cfg["task"])
            variables = random_variables(JNet(spec, n_points=N_PAD),
                                         jb.cloud)
            path = str(tmp / "weights.pth")
            torch.save(tckpt.from_jax_variables(
                variables["params"], variables["batch_stats"], spec), path)
            made[name] = root, path
        return made[name]

    return get


def _cfg(name, root, weights, outdir, **extra):
    return dict(_config(name), data_path=root, n_pad=N_PAD, model=SEG_MODEL,
                weights=weights, outdir=outdir, batch_size=2, epochs=1,
                val_every=5, save_every=1, num_workers=1, **extra)


class Batches:
    """The numpy batches each package's shuffled (train) loader yields."""

    def __init__(self, monkeypatch):
        self.got = {"jax": [], "port": []}
        for pkg, cls in (("jax", JLD.PrefetchLoader),
                         ("port", TLD.PrefetchLoader)):
            monkeypatch.setattr(cls, "epoch", self._spy(cls.epoch, pkg))

    def _spy(self, epoch, pkg):
        def batches(loader, epoch_=0):
            for b in epoch(loader, epoch_):
                if loader.shuffle:
                    self.got[pkg].append(b)
                yield b
        return batches


def _same_batch(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "_meta":
            assert len(got[k]) == len(v)
            for g, w in zip(got[k], v):
                assert g.keys() == w.keys()
                for mk in w:
                    assert np.array_equal(g[mk], w[mk]), mk
        else:
            assert np.array_equal(got[k], v) and got[k].dtype == v.dtype, k


@pytest.mark.parametrize("name", ["nuscenes", "shapenet-seg"])
def test_train_from_files_matches_jax_main(name, data, tmp_path,
                                           monkeypatch):
    root, weights = data(name)
    spies = Spies(monkeypatch)
    batches = Batches(monkeypatch)
    jcfg = _cfg(name, root, weights, str(tmp_path / "jax"))
    tcfg = _cfg(name, root, weights, str(tmp_path / "port"), device="cpu")
    jmain.main(jcfg)
    tmain.main(tcfg)
    # 4 train files, batches of 2
    assert spies.jax_steps == [2] and len(spies.port) == 2
    assert len(batches.got["jax"]) == len(batches.got["port"]) == 2
    for got, want in zip(batches.got["port"], batches.got["jax"]):
        _same_batch(got, want)
    if name == "nuscenes":
        # PolarMix on: the train samples are not the frames as read
        ds = tmain.load_datasets(tcfg)[0]
        assert ds.polarmix_aug
        frame_pts = sorted(len(ds.get(i).pos) for i in range(len(ds)))
        mixed = sorted(int(v.sum()) + int(d) for b in batches.got["port"]
                       for v, d in zip(b["valid"], b["n_pad_dropped"]))
        assert mixed != frame_pts
    want = [float(spies.jax_sched(s)) for s in range(2)]
    np.testing.assert_allclose([lr for lr, _ in spies.port], want,
                               rtol=1e-6)
    assert [m for _, m in spies.port] == [spies.jax_bn[0][1]] * 2
    names = {"epoch0", "latest", "latest_state.json", "metrics.jsonl"}
    assert set(os.listdir(jcfg["outdir"])) == names
    assert set(os.listdir(tcfg["outdir"])) == names


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, files in os.walk(root) for f in files
            if f.endswith((".bin", ".label"))}


@pytest.mark.parametrize("name", ["kitti", "nuscenes"])
def test_only_test_submissions_match_jax(name, data, tmp_path, monkeypatch):
    monkeypatch.setattr(jnb, "knn", direct_knn)
    root, weights = data(name)
    trees = {}
    for pkg, entry, extra in (("jax", jmain, {}),
                              ("port", tmain, {"device": "cpu"})):
        cfg = _cfg(name, root, weights, str(tmp_path / pkg),
                   only_test=True, **extra)
        assert np.isfinite(entry.main(cfg))
        trees[pkg] = _tree(cfg["outdir"])
    assert trees["port"].keys() == trees["jax"].keys()
    val = tmain.load_datasets(dict(_config(name), data_path=root,
                                   n_pad=N_PAD))[1]
    assert len(trees["jax"]) == len(val) == 2
    for rel, path in trees["jax"].items():
        with open(path, "rb") as f, open(trees["port"][rel], "rb") as g:
            assert g.read() == f.read(), rel
    # one prediction a point of each val frame, in the frame's order
    for i in range(len(val)):
        s = val.get(i)
        if name == "kitti":
            rel = os.path.join("method_predictions", "sequences", "08",
                               "predictions",
                               os.path.basename(s.meta["fpath"])[:-4]
                               + ".label")
            pred = np.fromfile(trees["port"][rel], np.uint32)
            assert set(np.unique(pred)) <= set(KITTI_RAW_IDS)
        else:
            rel = os.path.join("results", "lidarseg", "test",
                               s.meta["fname"])
            pred = np.fromfile(trees["port"][rel], np.uint8)
            assert pred.min() >= 1
        assert len(pred) == len(s.pos)


def _narrow_config(tmp_path, root, n_pad):
    cfg = _config("nuscenes")
    cfg.update(model=_shrink_feat_dims(cfg["model"], 8), data_path=root,
               n_pad=n_pad, device="cpu", outdir=str(tmp_path / "out"))
    path = str(tmp_path / f"narrow_{n_pad}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_calibrate_reports_budgets_on_files(data, tmp_path, capsys):
    root, _ = data("nuscenes")
    # frames of 300-600 points in rows of 256: n_pad truncates
    rc = calibrate.main(["--config", _narrow_config(tmp_path, root, 256),
                         "--scans", "2", "--device=cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "== calibration over 2 val scans (nuscenes, n_pad=256, cpu)" \
        in out
    assert "points past n_pad" in out and "raise n_pad" in out
    for line in ("budget_overflow_frac", "budget_occupancy",
                 "curve_window wanted_max", "n_pad_dropped"):
        assert line in out, line
    # the records of the full rows: a scan each, nothing past n_pad
    cfg = tconfig.parse_args(["--config",
                              _narrow_config(tmp_path, root, N_PAD)])
    info, _, val, model, _, _ = tmain._setup(cfg)
    totals = calibrate.collect(model.eval(), val, 2, info.task)
    assert totals["n_pad_dropped"] == [0.0, 0.0]
    assert all(len(v) == 2 for v in totals.values())
    assert any(k.endswith("/curve_budget_overflow") for k in totals)


def test_budget_audit_prints_every_channel(data, tmp_path, capsys,
                                           monkeypatch):
    root, _ = data("nuscenes")
    config = _narrow_config(tmp_path, root, 512)
    totals = budget_audit.audit(config, 512, 2, torch.device("cpu"))
    monkeypatch.setenv("AUDIT_CONFIG", config)
    monkeypatch.setenv("AUDIT_SCANS", "2")
    budget_audit.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "== telemetry over 2 scans (n_pad=512) ==" in out
    for k in totals:
        assert k in out
    assert "curve_window_wanted_max" in totals


def test_converted_checkpoint_gives_the_pth_logits(data, tmp_path):
    root, weights = data("shapenet-seg")
    cfg = _cfg("shapenet-seg", root, weights, str(tmp_path / "a"),
               device="cpu")
    # the converter builds the config's model: the tiny one here
    with open(tmp_path / "tiny.yaml", "w") as f:
        yaml.safe_dump(dict(_config("shapenet-seg"), model=SEG_MODEL), f)
    out = convert_checkpoint.convert(str(tmp_path / "tiny.yaml"), weights,
                                     3, 50, str(tmp_path / "conv"))
    assert out == os.path.join(str(tmp_path / "conv"), "torch_import")
    _, val, from_pth = tmain.build(cfg)
    _, _, native = tmain.build(dict(cfg, weights=out,
                                    outdir=str(tmp_path / "b")))
    batch = TD.to_device_batch(next(TD.batch_iterator(val, 2)),
                               "segmentation", "cpu")
    with torch.no_grad():
        want, _ = from_pth(batch.cloud)
        got, _ = native(batch.cloud)
    assert torch.equal(got, want)
