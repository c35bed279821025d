"""K8, the conv1d-fast-v2 train chain, against the JAX package on the CPU,
same numpy inputs (those of tests/test_pallas_conv1d.py's train test: B 2,
n_exp 640, C0 10, three layers of 16, h 2, used 600 / 512):

* the port's plain chain (torch autograd) and its autograd Function over
  the plain passes (the CUDA path's sequencing, with each pass's plain
  version) against ``pallas_conv1d.conv1d_chain_train(interpret=True)``
  and against the exact chain: values 3e-5, statistics 1e-5, gradients of
  xe and every parameter 2e-4 (the JAX test's own tolerances);
* each pass's plain version against ``_run_fwd_layer``,
  ``_run_bwd_reduce`` and ``_run_bwd_t`` in interpret mode, summed over
  the batch as the JAX VJP sums them (the JAX forward's one-pass
  statistics against the port's two-pass ones: 1e-5);
* the t pass's fused reduce sums of the previous layer (``prev_sums``)
  against ``_run_bwd_reduce`` in interpret mode on the JAX t pass's own
  d_u_prev (2e-4), and the kernel epilogue's summation order
  (``conv_tc.prev_sums_model``) against the plain sums within 1e-6 of the
  sum of the absolute terms;
* the train forward and backward of the flagship's conv steps (0 and 31,
  narrow widths) against the JAX module: outputs 1e-4, gradients 2e-3 of
  each parameter's largest, running statistics 1e-5;
* the train launch counts of K8 per step (a standalone reduce only for a
  chain's last layer: the inner layers' sums come from the t pass).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
from curvecloudnet_tpu.models import modules as jmod
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import pallas_conv1d
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
from curvecloudnet_tpu_torch.models import kernel_launches
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.ops import conv1d_train
from curvecloudnet_tpu_torch.ops import conv_tc
from test_pallas_conv1d import _exact_chain_train
from torch_port_utils import jax_init, lidar, load_step, to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, TILE = 2, 128


def _inputs():
    """tests/test_pallas_conv1d.py::test_train_chain_values_and_grads's
    draws, in its order, plus the output cotangent."""
    rng = np.random.default_rng(3)
    dims, c0, b, n_exp = (16, 16, 16), 10, 2, 640
    used = np.array([600, 512], np.int32)
    xe = rng.normal(size=(b, n_exp, c0)).astype(np.float32)
    for bi in range(b):
        xe[bi, used[bi]:] = 0.0
    params, cin = [], c0
    for cout in dims:
        params.append((
            rng.normal(size=((H + 1) * cin, cout)).astype(np.float32) * 0.2,
            rng.normal(size=cout).astype(np.float32) * 0.1,
            (rng.normal(size=cout) * 0.3 + 1.0).astype(np.float32),
            rng.normal(size=cout).astype(np.float32) * 0.1))
        cin = cout
    cot = rng.normal(size=(b, n_exp, dims[-1])).astype(np.float32)
    return xe, params, used, cot


@pytest.fixture(scope="module")
def jax_chains():
    """Values, statistics and gradients of both JAX chains."""
    xe, params, used, cot = _inputs()
    xe_j, used_j = jnp.asarray(xe), jnp.asarray(used)
    pj = tuple(tuple(map(jnp.asarray, p)) for p in params)
    chains = {
        "interpret": lambda x, p: pallas_conv1d.conv1d_chain_train(
            x, p, used_j, H, TILE, True),
        "exact": lambda x, p: _exact_chain_train(x, p, used_j, H)}
    out = {}
    for name, fn in chains.items():
        def loss(x, p, fn=fn):
            o, st = fn(x, p)
            return jnp.sum(o * cot), (o, st)
        (_, (o, st)), g = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(xe_j, pj)
        out[name] = (np.asarray(o), [tuple(map(np.asarray, s[:2])) for s in st],
                     np.asarray(g[0]), [np.asarray(t) for p in g[1] for t in p])
    return out


# the plain chain, and the CUDA path's autograd Function (on CPU tensors
# its passes run their plain versions)
PORT_CHAINS = {"plain": conv1d_train.conv1d_chain_train_ref,
               "function": conv1d_train.conv1d_chain_passes}


@pytest.mark.parametrize("port", sorted(PORT_CHAINS))
@pytest.mark.parametrize("ref", ["interpret", "exact"])
def test_train_chain_matches_jax(jax_chains, port, ref):
    xe, params, used, cot = _inputs()
    x = torch.tensor(xe, requires_grad=True)
    ps = [[torch.tensor(t, requires_grad=True) for t in p] for p in params]
    out, stats = PORT_CHAINS[port](x, ps, torch.from_numpy(used), H)
    (out * torch.from_numpy(cot)).sum().backward()
    j_out, j_stats, j_dx, j_dp = jax_chains[ref]
    np.testing.assert_allclose(out.detach().numpy(), j_out, rtol=3e-5,
                               atol=3e-5)
    for (mean, var, n), (j_mean, j_var) in zip(stats, j_stats):
        assert float(n) == float(used.sum())
        np.testing.assert_allclose(mean.detach().numpy(), j_mean, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(var.detach().numpy(), j_var, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), j_dx, rtol=2e-4, atol=2e-4)
    for got, want in zip([t.grad for p in ps for t in p], j_dp):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=1)
def _jax_forward():
    """(z per layer, statistics, n) of the JAX interpret chain."""
    xe, params, used, _ = _inputs()
    pj = tuple(tuple(map(jnp.asarray, p)) for p in params)
    _, zs, stats, _, n = pallas_conv1d._chain_train_fwd_impl(
        jnp.asarray(xe), pj, jnp.asarray(used), H, TILE, True)[1]
    return zs, stats, n


def _layer_inputs(layer: int):
    """The inputs of one layer's passes: z_prev (xe on layer 0), the BNs
    from the JAX interpret chain's statistics, a cotangent of u."""
    xe, params, used, _ = _inputs()
    zs, stats, n = _jax_forward()

    def bn(li):
        mu, var = stats[li]
        return (np.asarray(mu), np.asarray(jax.lax.rsqrt(var + 1e-5)),
                params[li][2], params[li][3])

    z_prev = xe if layer == 0 else np.asarray(zs[layer - 1])
    bn_prev = None if layer == 0 else bn(layer - 1)
    rng = np.random.default_rng(10 + layer)
    d_u = rng.normal(size=zs[layer].shape).astype(np.float32)
    return dict(z_prev=z_prev, bn_prev=bn_prev, z=np.asarray(zs[layer]),
                bn=bn(layer), w=params[layer][0], b=params[layer][1],
                used=used, d_u=d_u, n=float(n))


def _t(a):
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(_t(t) for t in a)
    return torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else tuple(map(jnp.asarray, a))


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("pass_", ["fwd", "reduce", "t"])
def test_pass_plain_versions_match_pallas_interpret(pass_, layer):
    s = _layer_inputs(layer)
    bsz = s["used"].shape[0]
    if pass_ == "fwd":
        outs = [pallas_conv1d._run_fwd_layer(
            jnp.asarray(s["z_prev"][bi]), _j(s["bn_prev"]), jnp.asarray(s["w"]),
            jnp.asarray(s["b"]), int(s["used"][bi]), TILE, H, True,
            jnp.float32) for bi in range(bsz)]
        j_mean, j_var = pallas_conv1d._finalize_stats(
            sum(o[1] for o in outs), sum(o[2] for o in outs), s["n"])
        z, mean, var = conv1d_train.conv1d_train_fwd_layer(
            _t(s["z_prev"]), _t(s["bn_prev"]), _t(s["w"]), _t(s["b"]),
            _t(s["used"]), H)
        np.testing.assert_allclose(
            z.numpy(), np.stack([np.asarray(o[0]) for o in outs]), rtol=3e-5,
            atol=3e-5)
        np.testing.assert_allclose(mean.numpy(), j_mean, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), j_var, rtol=1e-5, atol=1e-5)
        return
    red = [pallas_conv1d._run_bwd_reduce(
        jnp.asarray(s["d_u"][bi]), jnp.asarray(s["z"][bi]), _j(s["bn"]),
        int(s["used"][bi]), TILE, True) for bi in range(bsz)]
    j_sums = [sum(r[i] for r in red) for i in range(4)]
    if pass_ == "reduce":
        got = conv1d_train.conv1d_train_bwd_reduce(
            _t(s["d_u"]), _t(s["z"]), _t(s["bn"]), _t(s["used"]))
        for g, w in zip(got, j_sums):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)
        return
    c1, c2 = j_sums[0] / s["n"], j_sums[1] / s["n"]
    outs = [pallas_conv1d._run_bwd_t(
        jnp.asarray(s["d_u"][bi]), jnp.asarray(s["z"][bi]),
        jnp.asarray(s["z_prev"][bi]), _j(s["bn"]), _j(s["bn_prev"]),
        jnp.asarray(s["w"]), c1, c2, int(s["used"][bi]), TILE, H, True,
        jnp.float32) for bi in range(bsz)]
    d_u_prev, dw, db = conv1d_train.conv1d_train_bwd_t(
        _t(s["d_u"]), _t(s["z"]), _t(s["z_prev"]), _t(s["bn"]),
        _t(s["bn_prev"]), _t(s["w"]), _t(c1), _t(c2), _t(s["used"]), H)
    want = (np.stack([np.asarray(o[0]) for o in outs]),
            sum(np.asarray(o[1]) for o in outs),
            sum(np.asarray(o[2]) for o in outs))
    for g, w in zip((d_u_prev, dw, db), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layer", [1, 2])
def test_t_pass_prev_sums_match_pallas_reduce(layer):
    """The plain t pass's fused sums (the previous layer's reduce over its
    d_u_prev) against ``_run_bwd_reduce`` in interpret mode applied to
    ``_run_bwd_t``'s d_u_prev, summed over the batch."""
    s = _layer_inputs(layer)
    bsz = s["used"].shape[0]
    red = [pallas_conv1d._run_bwd_reduce(
        jnp.asarray(s["d_u"][bi]), jnp.asarray(s["z"][bi]), _j(s["bn"]),
        int(s["used"][bi]), TILE, True) for bi in range(bsz)]
    c1 = sum(r[0] for r in red) / s["n"]
    c2 = sum(r[1] for r in red) / s["n"]
    j_sums = [0.0] * 4
    for bi in range(bsz):
        d_u_prev = pallas_conv1d._run_bwd_t(
            jnp.asarray(s["d_u"][bi]), jnp.asarray(s["z"][bi]),
            jnp.asarray(s["z_prev"][bi]), _j(s["bn"]), _j(s["bn_prev"]),
            jnp.asarray(s["w"]), c1, c2, int(s["used"][bi]), TILE, H, True,
            jnp.float32)[0]
        r = pallas_conv1d._run_bwd_reduce(
            d_u_prev, jnp.asarray(s["z_prev"][bi]), _j(s["bn_prev"]),
            int(s["used"][bi]), TILE, True)
        j_sums = [a + np.asarray(b) for a, b in zip(j_sums, r)]
    out = conv1d_train.conv1d_train_bwd_t(
        _t(s["d_u"]), _t(s["z"]), _t(s["z_prev"]), _t(s["bn"]),
        _t(s["bn_prev"]), _t(s["w"]), _t(c1), _t(c2), _t(s["used"]), H,
        prev_sums=True)
    assert len(out) == 4
    for g, w in zip(out[3], j_sums):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("used", [(600, 512), (0, 128), (129, 640), (1, 3)])
def test_prev_sums_model_matches_plain(used):
    """The t pass epilogue's order for the fused sums (per thread two rows,
    a butterfly over the warp's row lanes, the warps in order, the tiles
    by colsum) against the plain sums, within 1e-6 of the sum of the
    absolute terms; live counts inside the row, at 0 and a tile edge, one
    past a tile edge and at n_exp, and a few slots."""
    rng = np.random.default_rng(sum(used))
    b, n_exp, c = 2, 640, 16
    f = lambda *sh, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=sh) * sc).astype(np.float32))
    d_u_prev, z_prev = f(b, n_exp, c), f(b, n_exp, c)
    bn_prev = (f(c, sc=0.2), 1 + torch.rand(c) * 0.2, 1 + f(c, sc=0.2),
               f(c, sc=0.1))
    used_t = torch.tensor(used, dtype=torch.int32)
    got = conv_tc.prev_sums_model(d_u_prev, z_prev, bn_prev, used_t)
    want = conv1d_train.conv1d_train_bwd_reduce_ref(d_u_prev, z_prev,
                                                    bn_prev, used_t)
    live = conv1d_train._live(used_t, n_exp, "cpu").double()
    xhat, y = conv1d_train._affine(z_prev.double(), tuple(
        t.double() for t in bn_prev))
    da = (d_u_prev.double() * conv1d_train._dleaky(y) * live).abs()
    dxh = da * bn_prev[2].double().abs()
    for g, w, sc in zip(got, want, (dxh, dxh * xhat.abs(), da,
                                    da * xhat.abs())):
        scale = sc.sum((0, 1))
        assert bool(((g.double() - w.double()).abs() <= 1e-6 * scale).all())
    if used == (0, 128):  # only the first tile of sample 1 is live
        assert bool((got[2] != 0).any())


@pytest.fixture(scope="module")
def narrow():
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    mc = _shrink_feat_dims(cfg["model"], 8)
    return jparse(mc, in_dim=4, n_out=17), tparse(mc, in_dim=4, n_out=17)


@pytest.mark.parametrize("port", sorted(PORT_CHAINS))
@pytest.mark.parametrize("i", [0, 31])
def test_conv_step_train_matches_jax(narrow, i, port, monkeypatch):
    """SymmetricCurveConvStep in train: output, parameter gradients under a
    fixed cotangent and the updated running statistics against the JAX
    module's exact path, through the plain chain and through the autograd
    Function (its running statistics written from the Function's batch
    statistics)."""
    monkeypatch.setattr(conv1d_train, "conv1d_chain_train", PORT_CHAINS[port])
    jspec, tspec = narrow
    step, n = jspec.steps[i], 512
    port = TNet(tspec, n, feat_channels=1)
    c_in = port.in_widths[i]
    pos, x, cid, valid = lidar(n, seed=i, feat=c_in)
    jc = jcloud(*map(jnp.asarray, (pos, cid, valid, x)))
    tc = tcloud(*to_torch(pos, cid, valid, x))
    jm = jmod.SymmetricCurveConvStep(jspec, step, jspec.input_dim(i))
    variables = jax_init(jm, jc, seed=i)
    tmod = load_step(type(port.steps[i])(tspec, tspec.steps[i], c_in),
                     variables, step)

    def jloss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, jc,
                            train=True, bn_momentum=0.1,
                            mutable=["batch_stats"])
        r = jnp.sin(jnp.arange(out.x.size, dtype=jnp.float32)).reshape(
            out.x.shape)
        return jnp.sum(out.x * r * out.valid[..., None]), (out, mut)

    (_, (jout, mut)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tout = tmod(tc, train=True, bn_momentum=0.1)
    r = torch.sin(torch.arange(tout.x.numel(), dtype=torch.float32)).reshape(
        tout.x.shape)
    (tout.x * r * tout.valid[..., None]).sum().backward()
    v = np.asarray(jout.valid)
    np.testing.assert_allclose(tout.x.detach().numpy()[v],
                               np.asarray(jout.x)[v], rtol=1e-4, atol=1e-4)
    from types import SimpleNamespace

    one = SimpleNamespace(steps=(step,))
    name, prefix = f"step_0_{step.name}", "steps.0."
    want = tckpt.from_jax_variables({name: jg}, {}, one)
    got = {prefix + k: p for k, p in tmod.named_parameters()}
    assert want.keys() == got.keys()
    # floor for gradients that are zero in exact arithmetic (a conv bias
    # before its BatchNorm): 1e-5 of the largest gradient
    floor = 1e-5 * max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        err = float((got[k].grad - g).abs().max())
        assert err <= 2e-3 * float(g.abs().max()) + floor, (k, err)
    stats = {k[len(prefix):]: t for k, t in tckpt.from_jax_variables(
        {name: jg}, {name: mut["batch_stats"]}, one).items()
             if ".running_" in k}
    bufs = dict(tmod.named_buffers())
    assert stats.keys() == bufs.keys()
    for k, t in stats.items():
        np.testing.assert_allclose(bufs[k].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_train_launch_counts_count_k8(narrow):
    """Each conv1d-fast-v2 step with L layers launches L forward and L t
    passes a train step, and one standalone reduce (its last layer's; the
    inner layers, at most DW_FUSED wide, get theirs from the t pass): 2
    steps x 3 layers on the flagship, 2 reduces."""
    _, tspec = narrow
    want = kernel_launches(tspec, 36864, train=True)
    assert {k: want[k] for k in ("conv1d_train_fwd", "conv1d_train_reduce",
                                 "conv1d_train_t")} == {
        "conv1d_train_fwd": 6, "conv1d_train_reduce": 2, "conv1d_train_t": 6}
    assert "conv1d_chain" not in want


def test_train_function_runs_the_counted_passes(monkeypatch):
    """The autograd Function runs as many reduce and t passes as
    ``kernel_launches`` counts: a standalone reduce for the last layer and
    for a layer whose successor is wider than DW_FUSED, and the t pass
    asked for the previous layer's sums everywhere else."""
    seen = {"reduce": 0, "t": 0, "fused": 0}
    red, tpass = (conv1d_train.conv1d_train_bwd_reduce,
                  conv1d_train.conv1d_train_bwd_t)

    def count_red(*a, **kw):
        seen["reduce"] += 1
        return red(*a, **kw)

    def count_t(*a, prev_sums=False, **kw):
        seen["t"] += 1
        seen["fused"] += prev_sums
        return tpass(*a, prev_sums=prev_sums, **kw)

    monkeypatch.setattr(conv1d_train, "conv1d_train_bwd_reduce", count_red)
    monkeypatch.setattr(conv1d_train, "conv1d_train_bwd_t", count_t)
    g = torch.Generator().manual_seed(1)
    # inputs 4, then 40 (wider than DW_FUSED: a standalone reduce behind
    # it), 8, 6
    dims, cin, params = (40, 8, 6), 4, []
    for cout in dims:
        params.append([torch.randn((H + 1) * cin, cout, generator=g) * 0.3,
                       torch.zeros(cout), torch.ones(cout),
                       torch.zeros(cout)])
        cin = cout
    xe = torch.randn(1, 96, 4, generator=g, requires_grad=True)
    out, _ = conv1d_train.conv1d_chain_passes(
        xe, params, torch.tensor([90], dtype=torch.int32), H)
    out.sum().backward()
    assert seen == {"reduce": 2, "t": 3, "fused": 1}


def test_train_launch_counts_count_k7(narrow, monkeypatch):
    """K7's launches a flagship train step: its wrappers' kernel paths run
    on the CPU against a stand-in library that launches nothing, once per
    grouping step at the step's widths, K and aggregation; their counted
    launches sum to ``kernel_launches`` (2L + 2 forward and 4L backward a
    site of L denses, 3 and 7 more under attend: 88 and 120)."""
    from curvecloudnet_tpu_torch.models.modules import attend_dims
    from curvecloudnet_tpu_torch.ops import _build, group_train

    class Library:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(group_train, "_dptr", lambda t: None)
    monkeypatch.setattr(group_train, "_sm_count", lambda dev: 132)
    _, tspec = narrow
    g = torch.Generator().manual_seed(0)
    fwd = bwd = 0
    for i, step in enumerate(tspec.steps):
        if step.name not in ("sa", "sa-geo", "sgcnn"):
            continue
        dims = tuple(tspec.input_dim(i))[1:]
        att = (attend_dims(tspec, step, dims[-1])[1]
               if step.aggr_type == "attend" else 0)
        cfg = group_train.TrainCfg(dims=dims, att_dim=att,
                                   aggr=step.aggr_type, act="leaky_relu")
        k, m = step.knn or 25, 70
        h1 = torch.randn(1, k, m, dims[0], generator=g)
        mask = torch.rand(1, m, k, generator=g) < 0.5
        params = []
        for ci, co in zip(dims[:-1], dims[1:]):
            params += [torch.ones(ci), torch.zeros(ci), torch.ones(ci, co),
                       torch.zeros(co)]
        if att:
            params += [torch.ones(dims[-1], att), torch.zeros(att),
                       torch.ones(att), torch.zeros(att),
                       torch.ones(att, dims[-1]), torch.zeros(dims[-1])]
        group_train.group_train_fwd.launches = 0
        group_train.group_train_bwd.launches = 0
        out, stats, _, extras = group_train._kernel_fwd(h1, mask, cfg, params)
        d_h1, grads = group_train._kernel_bwd(h1, mask, cfg, params, stats,
                                              extras, torch.zeros_like(out))
        assert d_h1.shape == h1.shape
        assert [t.shape for t in grads] == [p.shape for p in params]
        fwd += group_train.group_train_fwd.launches
        bwd += group_train.group_train_bwd.launches
    want = kernel_launches(tspec, 36864, train=True)
    assert (fwd, bwd) == (want["group_train_fwd"], want["group_train_bwd"])
    assert (fwd, bwd) == (88, 120)
