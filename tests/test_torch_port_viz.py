"""The port's visualization layer and its entry points against the JAX
package's on the CPU:

* renders: ``render_numpy``, ``render_points`` and
  ``render_segmentation_panels`` equal to JAX's arrays; ``render_bev``,
  ``label_colormap`` and the QA colors equal; every ``plot_*`` figure
  written to its file; the generator's QA panels (``viz_every``);
* ``main --only_viz`` on a narrow nuScenes config (widths / 8, n_pad 512,
  one val scan) writes the files of JAX's ``run_viz`` from the same
  weights, with equal predictions behind ``seg_0``;
* ``main --only_val`` on a narrow shapenet-class config logs the
  classification loop's confusion figure, and says so where matplotlib
  is missing.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import curvecloudnet_tpu.visualization as JV
import curvecloudnet_tpu_torch.visualization as TV
from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu import main as jmain
from curvecloudnet_tpu.data import datasets as JD
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.run import tasks as JT
from curvecloudnet_tpu.simulator import qa_viz as JQ
from curvecloudnet_tpu.visualization import mitsuba_render as JMR
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import config as tconfig
from curvecloudnet_tpu_torch import main as tmain
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.simulator import generate as TG
from curvecloudnet_tpu_torch.simulator import qa_viz as TQ
from curvecloudnet_tpu_torch.visualization import mitsuba_render as TMR
from test_torch_port_eval import random_variables

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(n=300, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    return pos, rng.integers(0, 5, n), rng.integers(0, 5, n), rng.random(
        n) > 0.1


@pytest.mark.parametrize("preset", sorted(TMR.PRESETS))
def test_renders_match_jax(preset, monkeypatch):
    pos, pred, gt, valid = _cloud()
    colors = TV.label_colormap(6)[pred]
    np.testing.assert_array_equal(colors, JV.label_colormap(6)[pred])
    p, p_j = TMR.PRESETS[preset], JMR.PRESETS[preset]
    for q in (p, p_j):   # a small image: the splats loop over the points
        monkeypatch.setattr(q, "width", 96)
        monkeypatch.setattr(q, "height", 80)
    np.testing.assert_array_equal(
        TMR.render_numpy(p.transform(pos), colors, p),
        JMR.render_numpy(p_j.transform(pos), colors, p_j))
    # the lidar presets scale a scene down by 1/40 or 1/30
    scene = pos * (30.0 if preset in ("kitti", "audi") else 1.0)
    got = TV.render_segmentation_panels(scene, pred, gt,
                                        TV.label_colormap(6), preset=preset,
                                        valid=valid, backend="numpy")
    want = JV.render_segmentation_panels(scene, pred, gt,
                                         JV.label_colormap(6), preset=preset,
                                         valid=valid, backend="numpy")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (80, 192, 3) and got.std() > 0
    np.testing.assert_array_equal(TV.render_bev(pos, pred, valid, res=64),
                                  JV.render_bev(pos, pred, valid, res=64))


def test_plots_write_files(tmp_path):
    pos, pred, gt, valid = _cloud(seed=1)
    d = str(tmp_path)
    paths = [
        TV.plot_curve_cloud(pos, pred, valid, os.path.join(d, "c.png")),
        TV.plot_segmentation(pos, pred, gt, valid,
                             cmap=TV.label_colormap(5),
                             path=os.path.join(d, "s.png")),
        TV.plot_confusion(np.arange(16).reshape(4, 4), list("abcd"),
                          path=os.path.join(d, "m.png")),
        TV.grouping_edges_figure(pos, np.tile(np.arange(4), (300, 1)),
                                 valid=valid, path=os.path.join(d, "e.png")),
        TV.vector_cones_figure(pos, pos[::-1], valid,
                               path=os.path.join(d, "t.png")),
        TV.nocs_figure(pos, pos * 0.5, pos * 0.4,
                       path=os.path.join(d, "n.png")),
    ]
    TV.save_png(np.full((8, 8, 3), 0.5, np.float32), os.path.join(d, "p.png"))
    for p in paths + [os.path.join(d, "p.png")]:
        assert os.path.getsize(p) > 100, p
    assert TV.to_plotly_figure(pos, pred) is None   # plotly is absent here
    fig = TV.plot_confusion(np.eye(3), path=None)
    assert hasattr(fig, "savefig")


def test_qa_panels_match_jax(tmp_path):
    pos, cid, lab, _ = _cloud(200, seed=2)
    np.testing.assert_array_equal(TQ.curve_hash_colors(cid),
                                  JQ.curve_hash_colors(cid))
    np.testing.assert_array_equal(TQ.label_part_colors(lab),
                                  JQ.label_part_colors(lab))
    np.testing.assert_array_equal(
        TQ.visualize_scan_curves(pos, cid, backend="numpy"),
        JQ.visualize_scan_curves(pos, cid, backend="numpy"))
    TG.generate_dataset(str(tmp_path), n_samples=2, n_points=256,
                        resolution=96, density=0.5, seed=0, viz_every=1,
                        device="cpu")
    qa = sorted(os.listdir(tmp_path / "qa"))
    assert qa == ["curves_0.png", "curves_1.png", "seg_0.png", "seg_1.png"]


def test_main_only_viz_matches_jax(tmp_path, monkeypatch):
    """The same weights through JAX's ``run_viz`` and the port's ``main
    --only_viz``: the same figure files and equal predictions behind
    ``seg_0``."""
    cfg = tconfig.load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    cfg["model"] = _shrink_feat_dims(cfg["model"], 8)
    cfg.update(device="cpu", n_pad=512, n_val=1,
               outdir=str(tmp_path / "port"))
    info = JT.task_for("nuscenes", "segmentation")
    _, val = jmain.load_datasets(cfg)
    jspec = jparse(cfg["model"], in_dim=val.in_dim, n_out=info.n_out)
    jmodel = JNet(jspec, n_points=512)
    sample = JD.pad_sample(val.get(0), 512)
    cloud = JD.to_device_batch({k: v[None] for k, v in sample.items()},
                               "segmentation").cloud
    variables = random_variables(jmodel, cloud)
    preds = {}

    def spy(pkg, mod):
        orig = mod.plot_segmentation

        def plot(pos, pred, *args, **kwargs):
            preds[pkg] = np.asarray(pred)
            return orig(pos, pred, *args, **kwargs)
        monkeypatch.setattr(mod, "plot_segmentation", plot)

    spy("jax", JV)
    spy("port", TV)
    jmain.run_viz(jmodel, variables, val, info, cfg, str(tmp_path / "jax"),
                  n_samples=1)
    tspec = tparse(cfg["model"], in_dim=val.in_dim, n_out=info.n_out)
    tmodel = TNet(tspec, n_points=512, feat_channels=val.in_dim - 3)
    tmodel.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], tspec))
    tckpt.save_checkpoint(str(tmp_path), "weights", tmodel)
    assert tmain.main(dict(cfg, only_viz=True, weights=str(
        tmp_path / "weights"))) is None
    for sub in ("viz", "media"):
        got = sorted(os.listdir(tmp_path / "port" / sub))
        assert got == sorted(os.listdir(tmp_path / "jax" / sub)), sub
    assert "seg_0.png" in os.listdir(tmp_path / "port" / "viz")
    assert "viz_panels_0.png" in os.listdir(tmp_path / "port" / "media")
    np.testing.assert_array_equal(preds["port"], preds["jax"])
    assert len(np.unique(preds["port"])) > 1


def test_main_only_val_logs_confusion(tmp_path, monkeypatch, capsys):
    cfg = tconfig.load_config(os.path.join(REPO, "configs",
                                           "shapenet-class.yaml"))
    cfg["model"] = _shrink_feat_dims(cfg["model"], 8)
    cfg.update(device="cpu", n_pad=256, n_val=4, eval_batch_size=2,
               only_val=True, outdir=str(tmp_path / "a"))
    assert np.isfinite(tmain.main(cfg))
    assert os.path.getsize(tmp_path / "a" / "media" /
                           "eval_confusion.png") > 100
    with open(tmp_path / "a" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert any("media/eval/confusion" in rec for rec in logged)
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else find(name, *a)))
    assert np.isfinite(tmain.main(dict(cfg, outdir=str(tmp_path / "b"))))
    assert "confusion figure not drawn" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "b" / "media")
