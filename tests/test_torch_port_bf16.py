"""The port's ``compute_dtype: bfloat16`` eval against the JAX package on
the CPU.

* the plain versions of the kernels in bfloat16 against the Pallas
  functions in interpret mode on the same bfloat16 inputs: K2
  (``group_reduce_ref``, max and attend, k-major) and K1
  (``conv1d_chain_eval_ref``) within 2^-8 of the output's largest value;
  K1 on float32 input returns float32, bit-equal to the float32 chain;
  K9's plain version on bfloat16 rows within 1e-5 relative (it computes
  in float32, as the Pallas kernel); K4's plain gather of bfloat16 rows
  bit-equal to JAX's feature gather and to ``gather_rows``;
* the narrow nuScenes flagship (widths / 8, n 1024, B=1) and, under
  ``-m slow`` (the file's time budget), the narrow ShapeNet
  part-segmentation model (B=2, the category head, attend over 128 ball
  planes) in bfloat16: every step's output dtype equals JAX's
  (its conv steps on the Pallas chain in interpret mode,
  ``CCN_CONV_KERNEL=interp``, whose dtype is the kernel path's: step 0
  float32 from float32 input), the valid rows are equal, and the logits
  pass the yardstick: max and mean |port - JAX bf16| over live rows at
  most 2x JAX's own bf16-vs-f32 gap on the same weights and inputs;
* a bfloat16 model also trains (a train forward and the train entry's
  setup run; ``test_torch_port_bf16_train.py`` holds the step against
  JAX); parameters and buffers stay float32, and weights carried from JAX
  by ``from_jax_variables`` are float32;
* ``-m slow`` also: the flagship at full width (n 4096) on the same
  yardstick.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu import checkpoint as jckpt
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.data.synthetic import synthetic_object_batch
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import neighbors as jnb
from curvecloudnet_tpu.ops import pallas_conv1d, pallas_edge, pallas_gather
from curvecloudnet_tpu.ops import pallas_group
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.ops import (conv1d_chain, edge_mlp, gather,
                                         group_reduce)
from curvecloudnet_tpu_torch.ops.curve1d import window_concat_nomask
from torch_port_utils import direct_knn, lidar, to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_REL = 2.0 ** -8   # one bfloat16 rounding at the output's scale
YARDSTICK = 2.0        # x JAX's own bf16-vs-f32 gap


def _bf16(rng, shape, scale=1.0):
    """numpy f32 values that are exact in bfloat16, and the torch tensor."""
    t = torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))
    t = t.to(torch.bfloat16)
    return t.float().numpy(), t


def _layers(rng, dims):
    return [((rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
             (0.1 * rng.normal(size=b)).astype(np.float32))
            for a, b in zip(dims[:-1], dims[1:])]


def _torch_layers(layers):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]


def _jax_layers(layers):
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]


@pytest.mark.parametrize("aggr", ["max", "attend"])
def test_k2_bf16_matches_pallas(aggr):
    rng = np.random.default_rng(11)
    b, k, m, c1 = 2, 6, 40, 12
    h1_np, h1 = _bf16(rng, (b, k, m, c1), 2.0)
    mask = rng.random((b, m, k)) < 0.6
    mask[:, :3] = False                    # queries with no live slot
    s0 = (0.5 + rng.random(c1)).astype(np.float32)
    t0 = (0.1 * rng.normal(size=c1)).astype(np.float32)
    local = _layers(rng, (c1, 20, 24))
    att = _layers(rng, (24, 24, 24)) if aggr == "attend" else None
    want = pallas_group.fused_group_reduce(
        jnp.asarray(h1_np, jnp.bfloat16), jnp.asarray(mask),
        (jnp.asarray(s0), jnp.asarray(t0)), _jax_layers(local),
        _jax_layers(att) if att else None, aggr=aggr, act="leaky_relu",
        attend_act="leaky_relu", interpret=True, k_major=True)
    got = group_reduce.group_reduce_ref(
        h1, torch.from_numpy(mask), (torch.from_numpy(s0),
                                     torch.from_numpy(t0)),
        _torch_layers(local), _torch_layers(att) if att else None,
        aggr=aggr, act="leaky_relu")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())
    # the products really take bfloat16 operands: float32 ones differ
    f32 = group_reduce.group_reduce_ref(
        h1.float(), torch.from_numpy(mask), (torch.from_numpy(s0),
                                             torch.from_numpy(t0)),
        _torch_layers(local), _torch_layers(att) if att else None,
        aggr=aggr, act="leaky_relu")
    assert np.abs(f32.numpy() - want).max() > 4 * err


def _conv_inputs(rng, n_exp=300, c0=10, widths=(8, 16, 8), h=2):
    xe_np, xe = _bf16(rng, (1, n_exp, c0))
    dims = (c0,) + widths
    weights = [((rng.normal(size=((h + 1) * a, b))
                 / np.sqrt((h + 1) * a)).astype(np.float32),
                (0.1 * rng.normal(size=b)).astype(np.float32))
               for a, b in zip(dims[:-1], dims[1:])]
    return xe_np, xe, weights, 260


def test_k1_bf16_matches_pallas():
    rng = np.random.default_rng(12)
    h = 2
    xe_np, xe, weights, used = _conv_inputs(rng, h=h)
    want = pallas_conv1d.conv1d_chain_eval(
        jnp.asarray(xe_np[0], jnp.bfloat16), _jax_layers(weights),
        jnp.int32(used), half_k=h, interpret=True)
    got = conv1d_chain.conv1d_chain_eval_ref(
        xe, _torch_layers(weights), torch.tensor([used]), h)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got[0].float().numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())


def test_k1_float32_unchanged():
    """f32 xe: f32 out, bit-equal to the float32 chain (window concat ->
    dense -> leaky -> live mask a layer)."""
    rng = np.random.default_rng(13)
    h = 2
    xe_np, _, weights, used = _conv_inputs(rng, h=h)
    xe = torch.from_numpy(xe_np) + 1e-3 * torch.randn(
        xe_np.shape, generator=torch.Generator().manual_seed(0))
    tw = _torch_layers(weights)
    got = conv1d_chain.conv1d_chain_eval_ref(xe, tw, torch.tensor([used]), h)
    live = (torch.arange(xe.shape[1]) < used)[None, :, None]
    a = xe
    for w, b in tw:
        y = F.leaky_relu(window_concat_nomask(a, h) @ w + b, 0.01)
        a = torch.where(live, y, torch.zeros_like(y))
    assert got.dtype == torch.float32 and torch.equal(got, a)


def test_k4_bf16_gather_bit_equal():
    rng = np.random.default_rng(14)
    b, n, k, c = 2, 64, 5, 24
    x_np, x = _bf16(rng, (b, n, c), 3.0)
    idx = rng.integers(-1, n, size=(b, k, n)).astype(np.int32)
    xj = jnp.asarray(x_np, jnp.bfloat16)
    for fill in (True, False):
        got = gather.gather_km_ref(x, torch.from_numpy(idx), fill=fill)
        want = jnb.gather_neighbors(xj, jnp.asarray(idx), layout="kq",
                                    fill=fill)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    kern = np.stack([np.asarray(pallas_gather.gather_rows(
        xj[i], jnp.asarray(idx[i]), interpret=True).astype(jnp.float32))
        for i in range(b)])
    np.testing.assert_array_equal(
        gather.gather_km_ref(x, torch.from_numpy(idx), fill=False)
        .float().numpy(), kern)


def test_k9_reads_bf16_rows():
    rng = np.random.default_rng(15)
    b, n, k, c = 1, 48, 6, 10
    x_np, x = _bf16(rng, (b, n, c))
    nbr = rng.integers(0, n, size=(b, n, k)).astype(np.int32)
    nbr[:, :, -2:][rng.random((b, n, 2)) < 0.5] = -1
    layers = _layers(rng, (2 * c, 16, 12))
    ws, bs = [w for w, _ in layers], [bb for _, bb in layers]
    got = edge_mlp.fused_edge_mlp_max_ref(
        x, torch.from_numpy(nbr), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(bb) for bb in bs])
    xj = jnp.asarray(x_np, jnp.bfloat16)
    safe = jnp.maximum(jnp.asarray(nbr), 0)
    want = pallas_edge.fused_edge_mlp_max(
        jax.vmap(lambda a, i: a[i])(xj, safe), xj, jnp.asarray(nbr >= 0),
        [jnp.asarray(w) for w in ws], [jnp.asarray(bb) for bb in bs],
        interpret=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


# --- the slice ---------------------------------------------------------

N = 1024


def _model_cfg(name, factor=8):
    cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    return _shrink_feat_dims(cfg["model"], factor) if factor else cfg["model"]


def _dims(name):
    task = predict.task_of(load_config(os.path.join(REPO, "configs",
                                                    f"{name}.yaml")))
    objects = task in predict.OBJECT_TASKS
    return (predict.OBJECT_IN_DIM if objects else predict.IN_DIM,
            predict.N_OUT[task], None if objects else 1)


def _build(name, n, batch, factor=8):
    """(JAX models {dtype: (spec, module)}, port models {dtype: model},
    JAX variables, inputs (jax cloud, jax cats, port cloud, port cats)):
    the port's random weights (``predict.init_weights``, seed 3) carried
    to JAX by ``load_torch_checkpoint`` and back by ``from_jax_variables``,
    shared by the float32 and bfloat16 models."""
    mc = _model_cfg(name, factor)
    in_dim, n_out, feat = _dims(name)
    src = TNet(tparse(mc, in_dim=in_dim, n_out=n_out), n, feat_channels=feat)
    predict.init_weights(src, torch.Generator().manual_seed(3))
    jspec32 = jparse(mc, in_dim=in_dim, n_out=n_out)
    params, stats = jckpt.load_torch_checkpoint(
        {k: v.numpy() for k, v in src.state_dict().items()}, jspec32)
    sd = tckpt.from_jax_variables(params, stats, jspec32)
    jax_models, port = {}, {}
    for dt in ("float32", "bfloat16"):
        mcd = dict(mc, compute_dtype=dt)
        jspec = jparse(mcd, in_dim=in_dim, n_out=n_out)
        jax_models[dt] = JNet(jspec, n_points=n)
        tm = TNet(tparse(mcd, in_dim=in_dim, n_out=n_out), n,
                  feat_channels=feat)
        tm.load_state_dict(sd, strict=True)
        port[dt] = tm.eval()
    if feat is None:
        pos, cid, valid, _, cats = synthetic_object_batch(
            np.random.default_rng(0), batch, n)
        x = None
    else:
        pos, x, cid, valid = lidar(n, batch=batch, seed=2)
        cats = None
    has_cats = port["float32"].lin_categorical is not None
    jc = jcloud(*map(jnp.asarray, (pos, cid, valid)),
                None if x is None else jnp.asarray(x))
    tc = tcloud(*to_torch(pos, cid, valid),
                None if x is None else torch.from_numpy(x))
    inputs = (jc, jnp.asarray(cats) if has_cats else None, tc,
              torch.from_numpy(cats) if has_cats else None)
    return jax_models, port, {"params": params, "batch_stats": stats}, inputs


def _jax_forward(jm, variables, jc, jcats):
    """(logits as f32 numpy, valid, {step name: output x dtype name})."""
    def fn(v, c, cats):
        return jm.apply(v, c, cats, train=False, mutable=["intermediates"],
                        capture_intermediates=lambda mdl, meth: (
                            meth == "__call__" and mdl.name is not None
                            and mdl.name.startswith("step_")))

    (logits, valid), inter = jax.jit(fn)(variables, jc, jcats)
    dtypes = {k: str(v["__call__"][0].x.dtype)
              for k, v in inter["intermediates"].items()}
    return (np.asarray(logits.astype(jnp.float32)), np.asarray(valid),
            str(logits.dtype), dtypes)


def _port_forward(model, tc, tcats):
    dtypes = {}
    hooks = [mod.register_forward_hook(
        lambda m, a, out, name=f"step_{i}_{st.name}": dtypes.__setitem__(
            name, str(out.x.dtype).replace("torch.", "")))
        for i, (mod, st) in enumerate(zip(model.steps, model.spec.steps))]
    try:
        with torch.no_grad():
            logits, valid = model(tc, tcats)
    finally:
        for h in hooks:
            h.remove()
    return (logits.float().numpy(), valid.numpy(),
            str(logits.dtype).replace("torch.", ""), dtypes)


def _hold_slice(jax_models, port, variables, inputs, monkeypatch,
                exact_search=False):
    """The bf16 port against JAX: per-step dtypes, valid rows, yardstick.
    Returns (port error max, JAX gap max)."""
    jc, jcats, tc, tcats = inputs
    monkeypatch.setenv("CCN_CONV_KERNEL", "interp")
    if exact_search:
        monkeypatch.setattr(jnb, "knn", direct_knn)
    j32, jvalid, _, _ = _jax_forward(jax_models["float32"], variables, jc,
                                     jcats)
    j16, jvalid16, jdt, jsteps = _jax_forward(jax_models["bfloat16"],
                                              variables, jc, jcats)
    t16, tvalid, tdt, tsteps = _port_forward(port["bfloat16"], tc, tcats)
    assert jdt == tdt == "bfloat16"
    assert tsteps == jsteps, {k: (tsteps.get(k), v) for k, v in
                              jsteps.items() if tsteps.get(k) != v}
    np.testing.assert_array_equal(jvalid, jvalid16)
    np.testing.assert_array_equal(tvalid, jvalid)
    rows = jvalid
    gap = np.abs(j16 - j32)[rows]
    err = np.abs(t16 - j16)[rows]
    assert np.isfinite(t16[rows]).all() and gap.max() > 0
    assert err.max() <= YARDSTICK * gap.max(), (err.max(), gap.max())
    assert err.mean() <= YARDSTICK * gap.mean(), (err.mean(), gap.mean())
    return err.max(), gap.max()


@pytest.fixture(scope="module")
def flagship():
    return _build("nuscenes", N, 1)


def test_flagship_bf16_matches_jax(flagship, monkeypatch):
    jax_models, port, variables, inputs = flagship
    _hold_slice(jax_models, port, variables, inputs, monkeypatch)
    dtypes = _port_forward(port["bfloat16"], inputs[2], None)[3]
    # trap 1: the sweep's float32 features keep step 0's conv in float32
    assert dtypes["step_0_conv1d-fast-v2"] == "float32"
    assert dtypes["step_31_conv1d-fast-v2"] == "bfloat16"


@pytest.mark.slow
def test_shapenet_seg_bf16_matches_jax(monkeypatch):
    jax_models, port, variables, inputs = _build("shapenet-seg", N, 2)
    _hold_slice(jax_models, port, variables, inputs, monkeypatch,
                exact_search=True)


def test_bf16_evaluates_only(flagship, tmp_path):
    """Named when bfloat16 evaluated only; it now trains too: a train
    forward and the train entry's setup run on a bfloat16 model, whose
    parameters and buffers stay float32 (the bfloat16 train step against
    JAX: ``tests/test_torch_port_bf16_train.py``)."""
    import copy

    _, port, _, inputs = flagship
    model = copy.deepcopy(port["bfloat16"])
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        assert t.dtype == torch.float32, name
    logits, valid = model.train()(inputs[2], train=True)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits[valid].float()).all())
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        assert t.dtype == torch.float32, name
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    cfg["model"]["compute_dtype"] = "bfloat16"
    path = tmp_path / "nuscenes_bf16.yaml"
    path.write_text(yaml.safe_dump(cfg))
    from curvecloudnet_tpu_torch.train.__main__ import setup
    net, opt, _, _, batch, _ = setup(str(path), "cpu", 0, 1024)
    assert net.spec.compute_dtype == "bfloat16"
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert batch.cloud.valid.shape == (1, 1024)


def test_jax_weights_stay_float32(flagship):
    """``from_jax_variables`` under a bf16 spec: the same float32 tensors
    as under the f32 spec, loading strictly into the bf16 model."""
    jax_models, port, variables, _ = flagship
    sd = {dt: tckpt.from_jax_variables(variables["params"],
                                       variables["batch_stats"],
                                       jax_models[dt].spec)
          for dt in ("float32", "bfloat16")}
    assert sd["float32"].keys() == sd["bfloat16"].keys()
    for k, v in sd["bfloat16"].items():
        assert v.dtype == torch.float32 and torch.equal(v,
                                                        sd["float32"][k]), k
    port["bfloat16"].load_state_dict(sd["bfloat16"], strict=True)


@pytest.mark.slow
def test_flagship_full_width_bf16_matches_jax(monkeypatch):
    jax_models, port, variables, inputs = _build("nuscenes", 4096, 1,
                                                 factor=None)
    _hold_slice(jax_models, port, variables, inputs, monkeypatch)


@pytest.mark.parametrize("name", ["nuscenes", "kitti", "audi", "shapenet-seg",
                                  "kortx-testsplit", "shapenet-class"])
def test_k2_bf16_launch_shape_fits(name):
    """Every grouping site of a shipped config (its K planes) has a launch
    shape for K2-bf16: weight stages of 16 or 32 rows (the k-depth of the
    bfloat16 mma.sync), staged as bfloat16, within a block's shared
    memory."""
    from curvecloudnet_tpu_torch.ops import _build
    from curvecloudnet_tpu_torch.models import modules as tmod

    in_dim, n_out, _ = _dims(name)
    spec = tparse(_model_cfg(name, None), in_dim=in_dim, n_out=n_out)
    sites = 0
    for i, st in enumerate(spec.steps):
        if st.name not in ("sa", "sa-geo") + tmod.EDGE_STEPS:
            continue
        dims = spec.input_dim(i)
        if st.name in tmod.EDGE_STEPS:
            dims = tmod.edge_widths(st, dims, 64)[1]
        local = list(dims[1:])
        att = (list(tmod.attend_dims(spec, st, dims[-1]))
               if st.aggr_type == "attend" else [])
        chain = local + att[1:]
        if st.name == "sa-geo":
            k = 2 * st.curve_window + 1
        elif st.name in ("sa", "dgcnn-rad") and not st.knn:
            k = 128
        else:
            k = st.knn + (st.name == "sgcnn" and not st.use_sparse_feat_agg)
        rows, tq, kc = group_reduce._launch_shape(
            chain, local[-1], bool(att), k, 36864, 132,
            group_reduce._STAGE_ROWS_BF16, 2)
        assert kc in (16, 32)
        assert group_reduce._smem_bytes(rows, tq, kc, k, chain, local[-1],
                                        bool(att), 2) <= _build.MAX_SMEM
        sites += 1
    assert sites
