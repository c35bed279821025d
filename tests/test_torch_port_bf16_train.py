"""The port's ``compute_dtype: bfloat16`` training against the JAX package on
the CPU.

* the plain versions of the train kernels under the bfloat16 contract
  against the Pallas functions in interpret mode on the same bfloat16
  inputs: K7 (``group_train_fwd_ref`` / ``group_train_bwd_ref`` through
  ``_GroupTrain``, max and attend) against ``grouped_train_reduce``, K8's
  plain passes (``conv1d_chain_passes``) against ``conv1d_chain_train``,
  K4b (``scatter_km_ref``) against ``gather_rows``' VJP; outputs,
  statistics and gradients within bfloat16 roundings (2^-8) of each
  quantity's largest value, and float32 operands measurably further off
  (the products really take bfloat16 ones); K8 on float32 xe bit-equal to
  the float32 chain;
* each train-step module of the narrow flagship (step 31 here; steps 0,
  1, 3, 5 and 14 under ``-m slow``) in bfloat16 against JAX's module on
  its Pallas train kernels in interpret mode
  (``CCN_FUSED_GROUP_TRAIN=interp``, ``CCN_CONV_KERNEL_TRAIN=interp``;
  JAX's float32 module on the same values in float32): outputs, running
  statistics and every parameter's gradient each within 2x JAX's own
  bfloat16-vs-float32 gap of that quantity plus the float32 module
  tests' tolerance (a step on float32 input computes in float32);
* under ``-m slow`` (~3.5 min: JAX's whole step in interpret mode, the
  file's time budget), the narrow slice (widths / 8, n_pad 1024, B=2)
  through JAX's ``value_and_grad`` of the nuScenes loss on the same
  kernels: the loss (of each package's logits, op by op) and the logits
  (max and mean over live rows) within 2x JAX's bfloat16-vs-float32 gap,
  running statistics within 2x their gap, float32 parameters and
  gradients; no elementwise whole-model gradient bound: train-mode
  BatchNorm over the 33 steps turns each flipped bfloat16 rounding into
  a large gradient change (a 1e-6 weight perturbation moves JAX's own
  bf16 gradients by more than their norm);
* three port bfloat16 train steps lower the loss;
* the seg loss on bfloat16 logits (N 4096) equals JAX's op by op (JAX
  eager: under ``jit`` XLA fuses away some of the bfloat16 roundings of
  ``log_softmax``) within 1e-6 relative; its float32 value is unchanged.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.ops import pallas_conv1d, pallas_gather
from curvecloudnet_tpu.ops.pallas_group_train import grouped_train_reduce
from curvecloudnet_tpu.run import losses as jlosses
from curvecloudnet_tpu_torch.ops import conv1d_train, gather, group_train
from curvecloudnet_tpu_torch.ops.curve1d import window_concat_nomask
from curvecloudnet_tpu_torch.run import losses as tlosses

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_REL = 2.0 ** -8   # one bfloat16 rounding at a quantity's scale
YARDSTICK = 2.0        # x JAX's own bf16-vs-f32 gap


def _bf16(rng, shape, scale=1.0):
    """numpy f32 values that are exact in bfloat16."""
    t = torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _amax(x):
    return float(np.abs(np.asarray(x, np.float32)).max())


def _hold(got, want, name, rel=BF16_REL, floor=0.0):
    """|got - want| within ``rel`` of want's largest value (plus
    ``floor``); returns the error."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rel * _amax(want) + floor, (name, err, _amax(want))
    return err


def _hold_grads(grads, want):
    """Each parameter's gradient within two bfloat16 roundings of its
    largest value, plus a floor of 2^-10 of the call's largest gradient:
    gradients that are 0 in exact arithmetic (a bias feeding a BatchNorm,
    whose sum the BN backward cancels) are rounding noise of that scale."""
    floor = BF16_REL / 4 * max(_amax(w) for w in want)
    for i, (g, w) in enumerate(zip(grads, want)):
        _hold(g, w, f"grad {i}", 2 * BF16_REL, floor)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


def _k7_inputs(b, m, k, dims, a, seed):
    rng = np.random.default_rng(seed)
    h1 = _bf16(rng, (b, k, m, dims[0]), 2.0)
    mask = rng.random((b, m, k)) > 0.3
    mask[0, 3, :] = False      # a query with no live slot
    f32 = lambda t: t.astype(np.float32)  # noqa: E731
    params = []
    for i in range(len(dims) - 1):
        params += [f32(1 + 0.2 * rng.normal(size=dims[i])),
                   f32(0.1 * rng.normal(size=dims[i])),
                   f32(rng.normal(size=(dims[i], dims[i + 1]))
                       / np.sqrt(dims[i])),
                   f32(0.1 * rng.normal(size=dims[i + 1]))]
    if a:
        co = dims[-1]
        params += [f32(rng.normal(size=(co, a)) / np.sqrt(co)),
                   f32(0.1 * rng.normal(size=a)),
                   f32(1 + 0.2 * rng.normal(size=a)),
                   f32(0.1 * rng.normal(size=a)),
                   f32(rng.normal(size=(a, co)) / np.sqrt(a)),
                   f32(0.1 * rng.normal(size=co))]
    r = rng.normal(size=(b, m, dims[-1])).astype(np.float32)
    return h1, mask, params, r


def _jax_pdicts(params, n_loc, attend):
    loc = {}
    for i in range(n_loc):
        g, be, w, b = params[4 * i:4 * i + 4]
        loc[f"norm_{i}"] = {"scale": g, "bias": be}
        loc[f"lin_{i + 1}"] = {"kernel": w, "bias": b}
    att = None
    if attend:
        wa0, ba0, ga, ba, wa1, ba1 = params[4 * n_loc:]
        att = {"lin_0": {"kernel": wa0, "bias": ba0},
               "norm_0": {"scale": ga, "bias": ba},
               "lin_1": {"kernel": wa1, "bias": ba1}}
    return loc, att


def _jax_k7(h1, mask, params, dims, a, aggr, r, dtype):
    n_loc = len(dims) - 1
    row_valid = mask.any(-1).astype(np.float32)[..., None]
    loc, att = _jax_pdicts(params, n_loc, aggr == "attend")

    def jloss(h, loc_, att_):
        out, ls, ast = grouped_train_reduce(
            h, jnp.asarray(mask), loc_, n_loc + 1, att_, 2 if att_ else 0,
            aggr=aggr, interpret=True, tile_m=128)
        return jnp.sum(out * r * row_valid), (out, ls, ast)

    (_, (out, ls, ast)), g = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h1, dtype), loc, att)
    jloc, jatt = g[1], g[2]
    grads = []
    for i in range(n_loc):
        grads += [jloc[f"norm_{i}"]["scale"], jloc[f"norm_{i}"]["bias"],
                  jloc[f"lin_{i + 1}"]["kernel"], jloc[f"lin_{i + 1}"]["bias"]]
    if aggr == "attend":
        grads += [jatt["lin_0"]["kernel"], jatt["lin_0"]["bias"],
                  jatt["norm_0"]["scale"], jatt["norm_0"]["bias"],
                  jatt["lin_1"]["kernel"], jatt["lin_1"]["bias"]]
    stats = [s for mv in list(ls) + list(ast) for s in mv[:2]]
    return (out, stats, g[0], grads)


def _port_k7(h1, mask, params, dims, a, aggr, r, dtype):
    cfg = group_train.TrainCfg(dims=dims, att_dim=a, aggr=aggr,
                               act="leaky_relu")
    th1 = torch.tensor(h1).to(dtype).requires_grad_(True)
    tps = [torch.tensor(p, requires_grad=True) for p in params]
    out, n, *flat = group_train._GroupTrain.apply(
        cfg, th1, torch.from_numpy(mask), *tps)
    row_valid = torch.from_numpy(mask.any(-1))[..., None].float()
    (out * torch.from_numpy(r) * row_valid).sum().backward()
    return out.detach(), [f.detach() for f in flat], th1.grad, [
        p.grad for p in tps]


@pytest.mark.parametrize("aggr,dims,a", [("max", (8, 24, 16), 0),
                                         ("attend", (12, 16, 24), 24)])
def test_k7_bf16_plain_matches_pallas(aggr, dims, a):
    b, m, k = 2, 40, 6
    h1, mask, params, r = _k7_inputs(b, m, k, dims, a, seed=len(dims) + a)
    jout, jstats, jh1, jgrads = _jax_k7(h1, mask, params, dims, a, aggr, r,
                                        jnp.bfloat16)
    out, stats, gh1, grads = _port_k7(h1, mask, params, dims, a, aggr, r,
                                      torch.bfloat16)
    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    assert gh1.dtype == torch.bfloat16 and jh1.dtype == jnp.bfloat16
    assert all(g.dtype == torch.float32 for g in grads)
    live = mask.any(-1)
    err = _hold(out.numpy()[live], np.asarray(jout)[live], "out")
    for i, (s, js) in enumerate(zip(stats, jstats)):
        _hold(s, js, f"stat {i}")
    _hold(gh1.float(), np.asarray(jh1.astype(jnp.float32)), "d_h1",
          2 * BF16_REL)
    _hold_grads(grads, jgrads)
    # the bfloat16 contract is what makes them agree: float32 operands
    # (the float32 plain version on the same values) land further off
    out32 = _port_k7(h1, mask, params, dims, a, aggr, r, torch.float32)[0]
    assert np.abs(out32.numpy() - np.asarray(jout))[live].max() > 2 * err


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

def _k8_inputs(seed, b=2, n_exp=300, c0=10, widths=(8, 16, 8), h=2):
    rng = np.random.default_rng(seed)
    xe = _bf16(rng, (b, n_exp, c0))
    used = np.array([260, 231][:b], np.int32)
    xe[0, 260:] = 0
    xe[1, 231:] = 0
    dims = (c0,) + widths
    params = []
    for ci, co in zip(dims[:-1], dims[1:]):
        params.append((
            (rng.normal(size=((h + 1) * ci, co))
             / np.sqrt((h + 1) * ci)).astype(np.float32),
            (0.1 * rng.normal(size=co)).astype(np.float32),
            (1 + 0.2 * rng.normal(size=co)).astype(np.float32),
            (0.1 * rng.normal(size=co)).astype(np.float32)))
    cot = rng.normal(size=(b, n_exp, widths[-1])).astype(np.float32)
    return xe, params, used, cot, h


def _jax_k8(xe, params, used, cot, h, dtype):
    def f(x, ps):
        out, stats = pallas_conv1d.conv1d_chain_train(
            x, ps, jnp.asarray(used), h, 128, True)
        return jnp.sum(out.astype(jnp.float32) * cot), (out, stats)

    jp = tuple(tuple(jnp.asarray(t) for t in p) for p in params)
    (_, (out, stats)), g = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(xe, dtype), jp)
    return out, [s for mv in stats for s in mv[:2]], g[0], [
        t for p in g[1] for t in p]


def _port_k8(xe, params, used, cot, h, dtype, passes=True):
    tx = torch.tensor(xe).to(dtype).requires_grad_(True)
    tps = [tuple(torch.tensor(t, requires_grad=True) for t in p)
           for p in params]
    fn = (conv1d_train.conv1d_chain_passes if passes
          else conv1d_train.conv1d_chain_train_ref)
    out, stats = fn(tx, tps, torch.from_numpy(used), h)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return (out.detach(), [s.detach() for mv in stats for s in mv[:2]],
            tx.grad, [t.grad for p in tps for t in p])


def test_k8_bf16_plain_matches_pallas():
    xe, params, used, cot, h = _k8_inputs(21)
    jout, jstats, jdx, jgrads = _jax_k8(xe, params, used, cot, h,
                                        jnp.bfloat16)
    out, stats, dx, grads = _port_k8(xe, params, used, cot, h,
                                     torch.bfloat16)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    assert dx.dtype == torch.bfloat16 and jdx.dtype == jnp.bfloat16
    err = _hold(out.float(), np.asarray(jout.astype(jnp.float32)), "u_L")
    for i, (s, js) in enumerate(zip(stats, jstats)):
        _hold(s, js, f"stat {i}")
    _hold(dx.float(), np.asarray(jdx.astype(jnp.float32)), "d_xe",
          2 * BF16_REL)
    _hold_grads(grads, jgrads)
    # the plain chain (torch autograd) has the same forward contract
    ref = conv1d_train.conv1d_chain_train_ref(
        torch.tensor(xe).to(torch.bfloat16),
        [tuple(torch.tensor(t) for t in p) for p in params],
        torch.from_numpy(used), h)[0]
    assert torch.equal(ref, out)
    # float32 operands on the same values land further off
    out32 = _port_k8(xe, params, used, cot, h, torch.float32)[0]
    jf = np.asarray(jout.astype(jnp.float32))
    assert np.abs(out32.numpy() - jf).max() > 2 * err


def test_k8_float32_unchanged():
    """float32 xe: the plain chain and passes are the float32 chain, bit
    for bit (window concat -> one float32 product a layer)."""
    xe, params, used, _, h = _k8_inputs(22)
    xe = torch.tensor(xe) + 1e-3 * torch.randn(
        xe.shape, generator=torch.Generator().manual_seed(0))
    tps = [tuple(torch.tensor(t) for t in p) for p in params]
    tu = torch.from_numpy(used)
    live = conv1d_train._live(tu, xe.shape[1], xe.device)
    n = conv1d_train._count(tu)
    u, z_prev, bn_prev = xe, xe, None
    for w, b, g, be in tps:
        z = window_concat_nomask(u, h) @ w + b
        want = window_concat_nomask(conv1d_train._u_of(z_prev, bn_prev, live),
                                    h) @ w + b
        got, mean, var = conv1d_train.conv1d_train_fwd_layer_ref(
            z_prev, bn_prev, w, b, tu, h)
        assert got.dtype == torch.float32 and torch.equal(got, want)
        m, v = conv1d_train._masked_moments(z, live, n)
        u = conv1d_train._leaky((z - m) * torch.rsqrt(v + 1e-5) * g
                                + be) * live
        z_prev, bn_prev = got, (mean, torch.rsqrt(var + 1e-5), g, be)
    ref, _ = conv1d_train.conv1d_chain_train_ref(xe, tps, tu, h)
    assert ref.dtype == torch.float32 and torch.equal(ref, u)


# ---------------------------------------------------------------------------
# K4b
# ---------------------------------------------------------------------------


def test_k4b_bf16_plain_matches_pallas_vjp():
    rng = np.random.default_rng(23)
    n, k, c = 256, 9, 24
    src = _bf16(rng, (n, c))
    idx = np.clip(np.arange(n)[None, :] + rng.integers(-6, 7, size=(k, n)),
                  0, n - 1).astype(np.int32)
    idx[rng.random((k, n)) < 0.1] = -1
    cot = _bf16(rng, (k, n, c))

    def f(s):
        out = pallas_gather.gather_rows(s, jnp.asarray(idx), interpret=True)
        return out, jax.vjp(lambda t: pallas_gather.gather_rows(
            t, jnp.asarray(idx), interpret=True), s)[1]

    jout, vjp = f(jnp.asarray(src, jnp.bfloat16))
    (jd,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    assert jd.dtype == jnp.bfloat16
    ti = torch.from_numpy(idx)[None]
    got = gather.scatter_km_ref(torch.tensor(cot)[None].to(torch.bfloat16),
                                ti, n, fill=False)[0]
    assert got.dtype == torch.bfloat16
    want = np.asarray(jd.astype(jnp.float32))
    _hold(got.float(), want, "d_src")
    # f32 sums rounded once: the float64 sum rounded to bfloat16 differs
    # from it at most where the two roundings straddle a tie
    exact = np.zeros((n, c))
    live = idx >= 0
    np.add.at(exact, np.maximum(idx, 0)[live], cot.astype(np.float64)[live])
    once = torch.tensor(exact).to(torch.bfloat16).float().numpy()
    assert (got.float().numpy() != once).mean() < 0.01
    # through the autograd gather: d_src has the source's dtype
    ts = torch.tensor(src)[None].to(torch.bfloat16).requires_grad_(True)
    out = gather.gather_rows_km(ts, ti, fill=False)
    np.testing.assert_array_equal(out[0].detach().float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    out.backward(torch.tensor(cot)[None].to(torch.bfloat16))
    assert ts.grad.dtype == torch.bfloat16
    assert torch.equal(ts.grad[0], got)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_seg_loss_bf16_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, c = 4096, 17
    x = (3 * rng.normal(size=(1, n, c))).astype(np.float32)
    labels = rng.integers(0, c, (1, n)).astype(np.int32)
    valid = rng.random((1, n)) < 0.8
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = float(jlosses.seg_loss(jnp.asarray(x, jdt), labels, valid,
                                      ignore_index=0, use_lovasz=True))
        got = tlosses.seg_loss(torch.tensor(x).to(tdt),
                               torch.from_numpy(labels),
                               torch.from_numpy(valid), ignore_index=0,
                               use_lovasz=True)
        # the sum of the bfloat16 NLL and the float32 Lovász term
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want), (tdt, got, want)
    # float32: unchanged, torch's fused log_softmax and softmax
    t = torch.tensor(x)
    lab, val = torch.from_numpy(labels), torch.from_numpy(valid)
    flat = t.reshape(-1, c)
    nll = tlosses.nll_loss(torch.log_softmax(flat, -1), lab.reshape(-1),
                           val.reshape(-1), 0)
    lv = val.reshape(-1) & (lab.reshape(-1) != 0)
    lov = tlosses.lovasz_softmax(torch.softmax(flat, -1), lab.reshape(-1), lv)
    assert torch.equal(tlosses.seg_loss(t, lab, val, ignore_index=0,
                                        use_lovasz=True), nll + lov)


# ---------------------------------------------------------------------------
# the train-step modules
# ---------------------------------------------------------------------------

MOMENTUM = 0.1


def _narrow_cfg():
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    return _shrink_feat_dims(cfg["model"], 8)


def _specs(mc):
    from curvecloudnet_tpu.models import parse_model_config as jparse
    from curvecloudnet_tpu_torch.models import parse_model_config as tparse

    return {dt: (jparse(dict(mc, compute_dtype=dt), in_dim=4, n_out=17),
                 tparse(dict(mc, compute_dtype=dt), in_dim=4, n_out=17))
            for dt in ("float32", "bfloat16")}


def _gap_hold(got, j16, j32, name, floor):
    """|got - JAX bf16| within 2x |JAX bf16 - JAX f32| plus ``floor`` (the
    float32 tests' tolerance: a step whose input is float32 computes in
    float32 in both packages, so its gap is 0)."""
    got, j16, j32 = (np.asarray(t, np.float32) for t in (got, j16, j32))
    err = float(np.abs(got - j16).max())
    gap = float(np.abs(j16 - j32).max())
    assert err <= YARDSTICK * gap + floor, (name, err, gap, floor)
    return err, gap


# step index in the flagship -> row size the module test runs at; the last
# conv (K8 in bfloat16) runs in tier 1, the rest under -m slow (the file's
# time budget; the slice below runs K7 in bfloat16 at every site)
MODULE_STEPS = [(31, 512),
                pytest.param(0, 512, marks=pytest.mark.slow),
                pytest.param(1, 512, marks=pytest.mark.slow),
                pytest.param(3, 512, marks=pytest.mark.slow),
                pytest.param(5, 768, marks=pytest.mark.slow),
                pytest.param(14, 384, marks=pytest.mark.slow)]


@pytest.mark.parametrize("i,n", MODULE_STEPS)
def test_train_module_bf16_matches_jax(i, n, monkeypatch):
    from types import SimpleNamespace

    from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
    from curvecloudnet_tpu.models import modules as jmod
    from curvecloudnet_tpu_torch import checkpoint as tckpt
    from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
    from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
    from torch_port_utils import jax_init, lidar, load_step, to_torch

    monkeypatch.setenv("CCN_SPLIT_EDGE", "force")
    monkeypatch.setenv("CCN_FUSED_GROUP_TRAIN", "interp")
    monkeypatch.setenv("CCN_CONV_KERNEL_TRAIN", "interp")
    specs = _specs(_narrow_cfg())
    tspec = specs["bfloat16"][1]
    port_net = TNet(tspec, n, feat_channels=1)
    c_in = port_net.in_widths[i]
    pos, x, cid, valid = lidar(n, seed=i, feat=c_in)
    # the sweep's features are float32 (step 0); later steps take the
    # bfloat16 features of the step before
    xdt = np.float32 if i == 0 else jnp.bfloat16
    x = np.asarray(jnp.asarray(x, xdt).astype(jnp.float32))
    step = specs["float32"][0].steps[i]
    dims = specs["float32"][0].input_dim(i)
    budget = step.out_budget(n)
    r = np.sin(np.arange(n * 256, dtype=np.float32))

    def jmodule(jspec):
        st = jspec.steps[i]
        return {"conv1d-fast-v2": lambda: jmod.SymmetricCurveConvStep(
                    jspec, st, dims),
                "sa-geo": lambda: jmod.CurveSAStep(jspec, st, dims, budget),
                "sgcnn": lambda: jmod.EdgeConvStep(jspec, st, dims),
                "sa": lambda: jmod.SAStep(jspec, st, dims, budget)
                }[st.name]()

    def jrun(dt, variables):
        jm = jmodule(specs[dt][0])
        # the float32 model takes the same values in float32 (K8's and
        # K7's dtypes follow their inputs')
        jc = jcloud(*map(jnp.asarray, (pos, cid, valid)),
                    jnp.asarray(x, xdt if dt == "bfloat16" else np.float32))

        def jloss(params):
            out, mut = jm.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                jc, train=True, bn_momentum=MOMENTUM,
                                mutable=["batch_stats"])
            rr = r[:out.x.size].reshape(out.x.shape)
            return jnp.sum(out.x.astype(jnp.float32) * rr
                           * out.valid[..., None]), (out, mut)

        (_, (out, mut)), g = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(variables["params"])
        return out, mut, g

    variables = jax_init(jmodule(specs["float32"][0]),
                         jcloud(*map(jnp.asarray, (pos, cid, valid)),
                                jnp.asarray(x)), seed=i)
    j32 = jrun("float32", variables)
    j16 = jrun("bfloat16", variables)
    tstep = tspec.steps[i]
    args = {"conv1d-fast-v2": (tspec, tstep, c_in),
            "sa-geo": (tspec, tstep, dims, c_in, budget),
            "sgcnn": (tspec, tstep, dims, c_in, None),
            "sa": (tspec, tstep, dims, c_in, budget, None)}[step.name]
    tmod = load_step(type(port_net.steps[i])(*args), variables, step)
    tc = tcloud(*to_torch(pos, cid, valid), torch.tensor(x).to(
        torch.float32 if i == 0 else torch.bfloat16))
    tout = (tmod(tc, None, train=True, bn_momentum=MOMENTUM)
            if step.name in ("sa", "sgcnn")
            else tmod(tc, train=True, bn_momentum=MOMENTUM))
    assert str(tout.x.dtype).replace("torch.", "") == str(j16[0].x.dtype)
    rr = torch.from_numpy(r[:tout.x.numel()]).reshape(tout.x.shape)
    (tout.x.float() * rr * tout.valid[..., None]).sum().backward()
    v = np.asarray(j16[0].valid)
    np.testing.assert_array_equal(tout.valid.numpy(), v)
    o16 = np.asarray(j16[0].x.astype(jnp.float32))[v]
    _gap_hold(tout.x.detach().float().numpy()[v], o16,
              np.asarray(j32[0].x)[v], "out", 1e-4 * _amax(o16))
    name, prefix = f"step_0_{step.name}", "steps.0."
    one = SimpleNamespace(steps=(step,))
    g16 = tckpt.from_jax_variables({name: j16[2]}, {}, one)
    g32 = tckpt.from_jax_variables({name: j32[2]}, {}, one)
    got = {prefix + k: p for k, p in tmod.named_parameters()}
    assert got.keys() == g16.keys()
    floor = 1e-5 * max(_amax(g) for g in g16.values())
    for k, g in g16.items():
        assert got[k].dtype == torch.float32 and got[k].grad.dtype == \
            torch.float32, k
        _gap_hold(got[k].grad, g, g32[k], k, 2e-3 * _amax(g) + floor)
    s16 = tckpt.from_jax_variables({name: j16[2]},
                                   {name: j16[1]["batch_stats"]}, one)
    s32 = tckpt.from_jax_variables({name: j32[2]},
                                   {name: j32[1]["batch_stats"]}, one)
    bufs = {prefix + k: b for k, b in tmod.named_buffers()}
    for k, b in bufs.items():
        assert b.dtype == torch.float32, k
        _gap_hold(b, s16[k], s32[k], k, 1e-5 * max(_amax(s16[k]), 1.0))


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

N_SLICE = 1024


@pytest.fixture(scope="module")
def slice_bf16():
    """One train forward + backward of the narrow flagship (widths / 8,
    n 1024, B=2) in both packages and both dtypes, from the same weights
    (JAX's init, carried by ``from_jax_variables``); JAX on its Pallas
    train kernels in interpret mode, whose bfloat16 contract the port's
    kernels take (its XLA route rounds each Dense's output to bfloat16)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CCN_SPLIT_EDGE", "force")
    mp.setenv("CCN_FUSED_GROUP_TRAIN", "interp")
    mp.setenv("CCN_CONV_KERNEL_TRAIN", "interp")
    try:
        return _slice_bf16()
    finally:
        mp.undo()


def _slice_bf16():
    from curvecloudnet_tpu.data.synthetic import synthetic_lidar_batch
    from curvecloudnet_tpu.models import CurveCloudNet as JNet
    from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
    from curvecloudnet_tpu_torch import checkpoint as tckpt
    from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
    from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
    from torch_port_utils import jax_init, to_torch

    specs = _specs(_narrow_cfg())
    rng = np.random.default_rng(0)
    pos, x, cid, valid, labels = synthetic_lidar_batch(rng, 2, N_SLICE)
    jc = jcloud(*map(jnp.asarray, (pos, cid, valid, x)))
    tc = tcloud(*to_torch(pos, cid, valid, x))
    variables = jax_init(JNet(specs["float32"][0], n_points=N_SLICE), jc)
    out = {"valid": valid, "labels": labels}
    for dt in ("float32", "bfloat16"):
        jm = JNet(specs[dt][0], n_points=N_SLICE)

        def loss_fn(p, jm=jm):
            (logits, out_valid), mut = jm.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, jc,
                train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"])
            loss = jlosses.seg_loss(logits, labels, out_valid & valid,
                                    ignore_index=0, use_lovasz=True)
            return loss, (logits, out_valid, mut["batch_stats"])

        (_, (jlogits, jvalid, jbs)), jg = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        # the loss of the step's logits op by op, as the port computes it
        # (under jit XLA keeps log_softmax's exps in f32 inside its fused
        # sum, which moves the bfloat16 NLL by up to an ulp)
        jl = jlosses.seg_loss(jlogits, labels, jvalid & valid,
                              ignore_index=0, use_lovasz=True)
        out[dt] = dict(loss=float(jl), logits=np.asarray(
            jlogits.astype(jnp.float32)), dtype=str(jlogits.dtype),
            stats=tckpt.from_jax_variables(jg, jbs, specs[dt][0]))
    tm = TNet(specs["bfloat16"][1], N_SLICE, feat_channels=1)
    tm.load_state_dict(tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"],
        specs["bfloat16"][0]), strict=True)
    logits, out_valid = tm(tc, train=True, bn_momentum=MOMENTUM)
    loss = tlosses.seg_loss(logits, torch.from_numpy(labels),
                            out_valid & torch.from_numpy(valid),
                            ignore_index=0, use_lovasz=True)
    loss.backward()
    out["port"] = dict(loss=float(loss.detach()), logits=logits.detach().float()
                       .numpy(), dtype=str(logits.dtype), model=tm)
    return out


@pytest.mark.slow
def test_slice_bf16_loss_and_logits_match_jax(slice_bf16):
    s = slice_bf16
    j16, j32, port = s["bfloat16"], s["float32"], s["port"]
    assert j16["dtype"] == "bfloat16" and port["dtype"] == "torch.bfloat16"
    gap = abs(j16["loss"] - j32["loss"])
    assert gap > 0
    assert abs(port["loss"] - j16["loss"]) <= YARDSTICK * gap, (
        port["loss"], j16["loss"], j32["loss"])
    v = s["valid"]
    err = np.abs(port["logits"] - j16["logits"])[v]
    lgap = np.abs(j16["logits"] - j32["logits"])[v]
    assert np.isfinite(port["logits"][v]).all() and lgap.max() > 0
    assert err.max() <= YARDSTICK * lgap.max(), (err.max(), lgap.max())
    assert err.mean() <= YARDSTICK * lgap.mean(), (err.mean(), lgap.mean())


@pytest.mark.slow
def test_slice_bf16_state_stays_float32(slice_bf16):
    """Parameters, gradients and BatchNorm buffers float32 and finite; the
    running statistics within 2x JAX's bf16-vs-f32 gap (plus 1e-5 of the
    buffer's scale) of JAX's bfloat16 ones."""
    s = slice_bf16
    tm = s["port"]["model"]
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    s16, s32 = s["bfloat16"]["stats"], s["float32"]["stats"]
    for name, b in tm.named_buffers():
        assert b.dtype == torch.float32, name
        _gap_hold(b, s16[name], s32[name], name,
                  1e-5 * max(_amax(s16[name]), 1.0))


def test_port_bf16_train_steps_lower_the_loss():
    from curvecloudnet_tpu.data.synthetic import synthetic_lidar_batch
    from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
    from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
    from curvecloudnet_tpu_torch.predict import init_weights
    from curvecloudnet_tpu_torch.train import Batch, LossConfig, train_step
    from curvecloudnet_tpu_torch.train.trainer import create_optimizer
    from torch_port_utils import to_torch

    tspec = _specs(_narrow_cfg())["bfloat16"][1]
    rng = np.random.default_rng(1)
    pos, x, cid, valid, labels = synthetic_lidar_batch(rng, 2, N_SLICE)
    model = TNet(tspec, N_SLICE, feat_channels=1)
    init_weights(model, torch.Generator().manual_seed(0))
    batch = Batch(cloud=tcloud(*to_torch(pos, cid, valid, x)),
                  labels=torch.from_numpy(labels))
    opt = create_optimizer(model)
    gen = torch.Generator().manual_seed(0)
    losses = [float(train_step(model, opt, 1e-3, batch, gen, MOMENTUM,
                               LossConfig(use_lovasz=True))["loss"])
              for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in model.parameters())
