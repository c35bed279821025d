"""The port's eval loop against the JAX package's on the CPU.

* metrics: every function of ``run/metrics.py`` equal to JAX's;
* the curve-window index tables: made once a device, usable in train;
* telemetry: the narrow flagship (widths / 8, n_pad 4608, 4 beams, as
  tests/test_budget_calibration.py runs it) and the narrow KITTI model
  under ``test_torch_port_kitti.lower_limits`` (grid rows, so
  ``grid_cap_drop.*`` records) give JAX's key set and values (1e-6),
  JAX's conv1d-fast-v2 on its exact path (the halo path, its CPU
  default, adds records of its own); telemetry values depend on
  positions only, so the JAX models run on zero weights;
* TTA forwards: the miniature every-step model of tests/test_model.py on
  a 512-point sweep; the port's per-view and view-batched forwards
  (views_per_call 1, 2, 3, 4, 6, 12) against JAX's 12-view mean (2e-3)
  and against each other (1e-5);
* the loops: ``evaluate_segmentation`` on 2 scans with TTA, per view and
  view-batched, against JAX's (mean logits 2e-3, telemetry keys equal and
  values 1e-6; histograms within twice the count of valid points whose
  JAX top-two margin is under 4e-3, and each equal to ``masked_hist`` of
  its own mean logits).  The object loops are held in
  tests/test_torch_port_driver.py.

The JAX side runs with ``key=None`` (the port's generator None) through
:class:`KeyNone`; its weights are drawn with numpy
(:func:`random_variables`) and carried to the port by
``checkpoint.from_jax_variables``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.data import datasets as JD
from curvecloudnet_tpu.data.synthetic import synthetic_lidar_batch
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import telemetry as jtel
from curvecloudnet_tpu.run import metrics as JM
from curvecloudnet_tpu.run import tasks as JT
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.data import datasets as TD
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.ops import telemetry as ttel
from curvecloudnet_tpu_torch.run import metrics as TM
from curvecloudnet_tpu_torch.run import tasks as TT
from test_model import unet_cfg
from test_torch_port_kitti import lower_limits
from torch_port_utils import to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 2e-3      # the full-model bar of the JAX parity tests
TIE_MARGIN = 4e-3     # top-two margins under 2 x LOGIT_TOL may flip
QUIET = dict(log=lambda *a: None)


class KeyNone:
    """The JAX model with every ``apply`` at ``key=None`` (the JAX loops
    pass ``PRNGKey(0)``, a draw torch cannot reproduce)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, key=None, **kwargs):
        return self.model.apply(variables, *args, **kwargs)


def _shapes(model, *args):
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda *a: model.init(
        {"params": key, "dropout": key}, *a, train=False), *args)


def _zero_variables(model, *args):
    """A JAX model's variables, all zeros, without compiling its init."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  _shapes(model, *args))


def random_variables(model, *args, seed: int = 1):
    """A JAX model's variables drawn with numpy, without compiling its
    init: kernels N(0, 1/fan_in), BN scale 1 + N(0, 0.1), biases and
    running means N(0, 0.1), running variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = jax.tree_util.keystr(path[-1:])
        if len(s.shape) >= 2:
            x = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif "var" in leaf:
            x = 0.5 + rng.random(s.shape)
        elif "scale" in leaf:
            x = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            x = 0.1 * rng.normal(size=s.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _shapes(model, *args))


def _jax_stats(model, variables, cloud):
    def f(v, c):
        with jtel.capture() as cap:
            model.apply(v, c, train=False)
            return cap.current()
    return {k: float(v) for k, v in jax.jit(f)(variables, cloud).items()}


def _port_stats(model, cloud):
    with torch.no_grad(), ttel.capture() as cap:
        model(cloud)
        return {k: float(v) for k, v in cap.current().items()}


def _assert_same_stats(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    n, size = 7, 500
    pred = rng.integers(-1, n + 1, size).astype(np.int32)
    label = rng.integers(-1, n + 1, size).astype(np.int32)
    valid = rng.random(size) < 0.8
    tp, tl, tv = (torch.from_numpy(a) for a in (pred, label, valid))
    for got, want in [
            (TM.fast_hist(tp, tl, n), JM.fast_hist(pred, label, n)),
            (TM.masked_hist(tp, tl, tv, n),
             JM.masked_hist(jnp.asarray(pred), jnp.asarray(label),
                            jnp.asarray(valid), n)),
            (TM.fast_hist_crop(tp, tl, tv, n),
             JM.fast_hist_crop(jnp.asarray(pred), jnp.asarray(label),
                               jnp.asarray(valid), n))]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hist = TM.masked_hist(tp, tl, tv, n)
    hist[3] = 0          # an absent class: NaN IoU
    jhist = hist.numpy()
    np.testing.assert_array_equal(TM.per_class_iu(hist),
                                  JM.per_class_iu(jhist))
    assert TM.miou(hist) == JM.miou(jhist)
    assert TM.confmat2acc(hist) == JM.confmat2acc(jhist)
    for got, want in zip(TM.confmat2precrec(hist),
                         JM.confmat2precrec(jhist)):
        np.testing.assert_array_equal(got, want)
    parts = np.array([1, 2, 5])
    assert TM.part_iou_shapenet(tp, tl, tv, parts) == \
        JM.part_iou_shapenet(pred, label, valid, parts)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def _exact_conv_path(mp):
    """JAX's conv1d-fast-v2 eval on the CPU takes its halo path, which
    also compacts the curve starts into the budget (``budget_*``
    records); its TPU kernel path, the port's K1, records only
    ``curve_budget_overflow``, as does the exact path chosen here."""
    mp.setenv("CCN_CONV_HALO", "0")


def test_flagship_telemetry_matches_jax(monkeypatch):
    _exact_conv_path(monkeypatch)
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    mc = _shrink_feat_dims(cfg["model"], 8)
    n_pad = 4608
    pos, x, cid, valid, _ = synthetic_lidar_batch(
        np.random.default_rng(3), 1, n_pad, n_beams=4)
    jc = jcloud(*map(jnp.asarray, (pos, cid, valid, x)))
    jm = JNet(jparse(mc, in_dim=4, n_out=17), n_points=n_pad)
    want = _jax_stats(jm, _zero_variables(jm, jc), jc)
    tm = TNet(tparse(mc, in_dim=4, n_out=17), n_pad, feat_channels=1).eval()
    got = _port_stats(tm, tcloud(*to_torch(pos, cid, valid, x)))
    _assert_same_stats(got, want)
    assert {"curve_window_truncated_frac", "fp_split_overflow.n2880",
            "step_0_conv1d-fast-v2/curve_budget_overflow",
            "budget_overflow_frac.2"} <= got.keys()
    # no record without a capture
    assert not ttel.active()


def test_kitti_telemetry_matches_jax():
    """Grid rows (the lowered table limit): ``grid_cap_drop`` records."""
    mp = pytest.MonkeyPatch()
    lower_limits(mp)
    _exact_conv_path(mp)
    try:
        cfg = load_config(os.path.join(REPO, "configs", "kitti.yaml"))
        mc = _shrink_feat_dims(cfg["model"], 8)
        n_pad = 4096
        pos, x, cid, valid, _ = synthetic_lidar_batch(
            np.random.default_rng(0), 2, n_pad,
            n_beams=predict.N_BEAMS["kitti"])
        jc = jcloud(*map(jnp.asarray, (pos, cid, valid, x)))
        jm = JNet(jparse(mc, in_dim=4, n_out=20), n_points=n_pad)
        want = _jax_stats(jm, _zero_variables(jm, jc), jc)
        tm = TNet(tparse(mc, in_dim=4, n_out=20), n_pad,
                  feat_channels=1).eval()
        got = _port_stats(tm, tcloud(*to_torch(pos, cid, valid, x)))
    finally:
        mp.undo()
    _assert_same_stats(got, want)
    assert sum(k.startswith("grid_cap_drop.") for k in got) == 2


def test_window_tables_are_made_once_outside_inference_mode():
    """The curve-window index tables are copied to a device once (a copy
    from host memory makes the host wait for the card), and one first
    made under inference mode still indexes in an autograd graph."""
    from curvecloudnet_tpu_torch.ops import curve1d

    curve1d._index_table.cache_clear()
    with torch.inference_mode():
        offs = curve1d._offsets(3, "cpu")
        curve1d.ascending_from_interleaved(torch.zeros(2, 7), 3)
    assert curve1d._offsets(3, torch.device("cpu")) is offs
    assert not offs.is_inference()
    np.testing.assert_array_equal(offs.numpy(),
                                  curve1d.interleaved_offsets(3))
    x = torch.arange(7.0, requires_grad=True)
    y = curve1d.ascending_from_interleaved(x * 1.0, 3)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  x.detach().numpy()[np.argsort(offs.numpy() + 3)])
    y.pow(2).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), 2 * x.detach().numpy())
    assert curve1d._index_table.cache_info().misses == 2


# ---------------------------------------------------------------------------
# TTA forwards and the segmentation loop (the miniature every-step model)
# ---------------------------------------------------------------------------

N_MINI = 512


@pytest.fixture(scope="module")
def mini():
    """The miniature model in both packages with the same weights, and a
    2-scan synthetic lidar val set."""
    jspec = jparse(unet_cfg(), in_dim=4, n_out=17)
    ds_j = JD.SyntheticLidarSeg(n_samples=2, n_pad=N_MINI, seed=2)
    ds_t = TD.SyntheticLidarSeg(n_samples=2, n_pad=N_MINI, seed=2)
    jb = JD.to_device_batch(next(JD.batch_iterator(ds_j, 1)), "segmentation")
    jm = JNet(jspec, n_points=N_MINI)
    variables = random_variables(jm, jb.cloud)
    tm = TNet(tparse(unet_cfg(), in_dim=4, n_out=17), N_MINI,
              feat_channels=1)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec), strict=True)
    return jm, variables, tm.eval(), ds_j, ds_t


@pytest.fixture(scope="module")
def jax_tta(mini):
    """JAX's 12-view mean logits of val scan 0 and its valid rows."""
    jm, variables, _, ds_j, _ = mini
    jb = JD.to_device_batch(next(JD.batch_iterator(ds_j, 1)), "segmentation")
    fwd = JT.make_tta_eval(KeyNone(jm))
    logits = [fwd(variables, jb.cloud, jnp.asarray(f), jnp.asarray(s))
              for f in JT.TTA_FLIPS for s in JT.TTA_SCALES]
    mean, _ = JT.make_eval_post(17, 0)([lg for lg, _ in logits], jb.labels,
                                       logits[0][1])
    return np.asarray(mean), np.asarray(logits[0][1])


def test_tta_views_and_registry_constants():
    np.testing.assert_array_equal(TT.TTA_FLIPS, JT.TTA_FLIPS)
    np.testing.assert_array_equal(TT.TTA_SCALES, JT.TTA_SCALES)
    views = TT.tta_views()
    order = [(f, s) for f in JT.TTA_FLIPS for s in JT.TTA_SCALES]
    for (f, s), fs in zip(order, views):
        np.testing.assert_array_equal(fs[:, 0], f)
        np.testing.assert_array_equal(fs[:, 1], [s, s])


@pytest.mark.parametrize("views_per_call", [None, 1, 2, 3, 4, 6, 12])
def test_tta_forwards_match_jax(mini, jax_tta, views_per_call):
    """None: the per-view forward and its post; else the view-batched
    forward at that many views a call."""
    _, _, tm, _, ds_t = mini
    want, valid = jax_tta
    tb = TD.to_device_batch(next(TD.batch_iterator(ds_t, 1)),
                            "segmentation", "cpu")
    per_view = TT.make_tta_eval(tm)
    logits = [per_view(tb.cloud, torch.from_numpy(f), torch.tensor(s))
              for f in TT.TTA_FLIPS for s in TT.TTA_SCALES]
    ref, _ = TT.make_eval_post(17, 0)([lg for lg, _ in logits], tb.labels,
                                      logits[0][1])
    if views_per_call is None:
        got, got_valid = ref, logits[0][1]
    else:
        got, got_valid, stats, hist = TT.make_batched_tta_eval(
            tm, views_per_call, n_cls=17, metric_ignore=0)(
                tb.cloud, tb.labels)
        # against the per-view forward: sums reassociated only
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert stats
        lv = got_valid & (tb.labels != 0)
        assert torch.equal(hist, TM.masked_hist(got.argmax(-1), tb.labels,
                                                lv, 17))
    np.testing.assert_array_equal(got_valid.numpy(), valid)
    err = np.abs(got.numpy() - want)[valid]
    assert np.isfinite(got.numpy()[valid]).all()
    assert err.max() <= LOGIT_TOL, err.max()


def _spy(mp, module, name, sink):
    """Wrap ``module.name`` (a factory of forwards) so every call of the
    forwards it makes appends (args, outputs) to ``sink``."""
    orig = getattr(module, name)

    def factory(*a, **kw):
        fn = orig(*a, **kw)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            sink.append((args, out))
            return out
        return wrapped
    mp.setattr(module, name, factory)


def _near_ties(mean_logits, counted):
    top2 = np.sort(mean_logits, axis=-1)[..., -2:]
    return int(((top2[..., 1] - top2[..., 0]) < TIE_MARGIN)[counted].sum())


@pytest.mark.parametrize("batched", [False, True])
def test_evaluate_segmentation_matches_jax(mini, batched, monkeypatch):
    _exact_conv_path(monkeypatch)
    jm, variables, tm, ds_j, ds_t = mini
    spied = {"jax": [], "port": []}
    name = "make_batched_tta_eval" if batched else "make_eval_post"
    _spy(monkeypatch, JT, name, spied["jax"])
    _spy(monkeypatch, TT, name, spied["port"])
    kw = dict(batched_tta=batched, tta_views_per_call=2, **QUIET)
    want = JT.evaluate_segmentation(KeyNone(jm), variables, ds_j,
                                    JT.TASKS["nuscenes"], **kw)
    got = TT.evaluate_segmentation(tm, ds_t, TT.TASKS["nuscenes"], **kw)
    # JAX's keys, and the port's TTA scan wall over the scan after warm-up
    assert got.keys() == want.keys() | {"scan_wall_s"}
    assert got["scan_wall_s"] == got["mean_forward_s"] * TT.N_VIEWS > 0
    assert got["class_names"] == want["class_names"]
    assert np.isnan(got["peak_device_memory_gb"])
    _assert_same_stats(got["overflow"], want["overflow"])
    assert len(spied["jax"]) == len(spied["port"]) == 2
    hist_at = 3 if batched else 1
    for (jargs, jout), (targs, tout), np_batch in zip(
            spied["jax"], spied["port"], TD.batch_iterator(ds_t, 1)):
        jmean, tmean = np.asarray(jout[0]), tout[0].numpy()
        valid = (np.asarray(jout[1]) if batched else np.asarray(jargs[2]))
        tvalid = tout[1] if batched else targs[2]
        np.testing.assert_array_equal(tvalid.numpy(), valid)
        err = np.abs(tmean - jmean)[valid]
        assert err.max() <= LOGIT_TOL, err.max()
        labels = np_batch["labels"]
        counted = valid & (labels != 0)
        jhist, thist = np.asarray(jout[hist_at]), tout[hist_at]
        assert np.abs(thist.numpy() - jhist).sum() <= \
            2 * _near_ties(jmean, counted)
        own = TM.masked_hist(tout[0].argmax(-1), torch.from_numpy(labels),
                             torch.from_numpy(counted), 17)
        assert torch.equal(thist, own)
