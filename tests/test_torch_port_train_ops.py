"""The port's train-path pieces against the JAX package on the CPU, same
numpy inputs:

* train-mode MaskedBatchNorm / MLP against flax (outputs, running
  statistics, ``stats_override``) — 1e-5;
* the segmentation losses against ``run/losses.py`` (value 1e-6, logit
  gradients 1e-6);
* each sampler fed JAX's own uniform draws picks exactly what the JAX
  sampler picks with that key;
* K4/K4b's plain versions against ``pallas_gather.gather_rows`` in
  interpret mode, forward (exact) and ``jax.grad`` (1e-6);
* K7's plain passes against ``grouped_train_reduce(interpret=True)`` and
  against torch autograd of the materialized chain, for attend and max:
  out, batch statistics, gradients of h1 and every parameter (the kernel's
  E[x^2] - mean^2 statistics against two-pass ones: 2e-5 on values, 5e-4
  relative on gradients, the JAX package's own bar);
* float64 ``gradcheck`` of the K7 and K4 autograd Functions;
* Adam and the learning-rate schedules against optax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from curvecloudnet_tpu.models import layers as jlayers
from curvecloudnet_tpu.ops import pallas_gather, sampling as jsmp
from curvecloudnet_tpu.ops.pallas_group_train import grouped_train_reduce
from curvecloudnet_tpu.run import losses as jlosses
from curvecloudnet_tpu.train import trainer as jtrainer
from curvecloudnet_tpu_torch.models.layers import MLP
from curvecloudnet_tpu_torch.ops import gather, group_train, sampling
from curvecloudnet_tpu_torch.run import losses
from curvecloudnet_tpu_torch.train import trainer
from torch_port_utils import lidar

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# BatchNorm / MLP
# ---------------------------------------------------------------------------


def _mlp_pair(dims, act, seed):
    rng = np.random.default_rng(seed)
    jm = jlayers.MLP(dims, act=act, use_bias=True)
    tm = MLP(dims, act=act, use_bias=True)
    params, stats = {}, {}
    with torch.no_grad():
        for i, lin in enumerate(tm.lins):
            w = (rng.normal(size=lin.weight.shape[::-1]) * 0.3).astype(np.float32)
            b = (0.1 * rng.normal(size=lin.out_features)).astype(np.float32)
            params[f"lin_{i}"] = {"kernel": w, "bias": b}
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
        for i, nrm in enumerate(tm.norms):
            c = nrm.weight.numel()
            vals = [(1 + 0.2 * rng.normal(size=c)), 0.1 * rng.normal(size=c),
                    0.1 * rng.normal(size=c), 0.5 + rng.random(c)]
            vals = [v.astype(np.float32) for v in vals]
            params[f"norm_{i}"] = {"scale": vals[0], "bias": vals[1]}
            stats[f"norm_{i}"] = {"mean": vals[2], "var": vals[3]}
            for t, v in zip((nrm.weight, nrm.bias, nrm.running_mean,
                             nrm.running_var), vals):
                t.copy_(torch.from_numpy(v))
    return jm, tm, {"params": params, "batch_stats": stats}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape,masked", [((2, 50, 6), True),
                                          ((2, 9, 7, 6), True),
                                          ((2, 40, 6), False)])
def test_train_mlp_matches_flax(shape, masked):
    jm, tm, variables = _mlp_pair((6, 12, 10, 5), "leaky_relu", 0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    mask = rng.random(shape[:-1]) > 0.3 if masked else None
    out, mut = jm.apply(variables, jnp.asarray(x), mask=mask, train=True,
                        bn_momentum=0.3, mutable=["batch_stats"])
    got = tm(torch.from_numpy(x), mask=None if mask is None else
             torch.from_numpy(mask), train=True, bn_momentum=0.3)
    _close(got.detach(), out, 1e-5)
    for i, nrm in enumerate(tm.norms):
        want = mut["batch_stats"][f"norm_{i}"]
        _close(nrm.running_mean, want["mean"], 1e-5)
        _close(nrm.running_var, want["var"], 1e-5)


def test_batchnorm_stats_override_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 8, 4)).astype(np.float32)
    mean, var = rng.normal(size=4).astype(np.float32), (
        0.5 + rng.random(4)).astype(np.float32)
    cnt = np.float32(17.0)
    bn = jlayers.MaskedBatchNorm()
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                use_running_average=True)
    out, mut = bn.apply(v, jnp.asarray(x), use_running_average=False,
                        momentum=0.2, stats_override=(mean, var, cnt),
                        mutable=["batch_stats"])
    from curvecloudnet_tpu_torch.models.layers import MaskedBatchNorm

    tb = MaskedBatchNorm(4)
    got = tb(torch.from_numpy(x), train=True, momentum=0.2,
             stats_override=tuple(map(torch.tensor, (mean, var, cnt))))
    _close(got.detach(), out, 1e-6)
    _close(tb.running_mean, mut["batch_stats"]["mean"], 1e-6)
    _close(tb.running_var, mut["batch_stats"]["var"], 1e-6)
    tb(torch.from_numpy(x), train=True, update_running=False)
    _close(tb.running_var, mut["batch_stats"]["var"], 1e-6)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lovasz,over_all", [(True, False), (False, True)])
def test_seg_loss_matches_jax(lovasz, over_all):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 300, 7)).astype(np.float32) * 2
    labels = rng.integers(0, 7, size=(2, 300)).astype(np.int32)
    valid = rng.random((2, 300)) > 0.1
    weights = (0.5 + rng.random(7)).astype(np.float32) if over_all else None

    def jloss(lg):
        return jlosses.seg_loss(lg, labels, valid, ignore_index=0,
                                use_lovasz=lovasz, lovasz_weight=1.5,
                                class_weights=weights,
                                mean_over_all=over_all)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = losses.seg_loss(lt, torch.from_numpy(labels),
                          torch.from_numpy(valid), ignore_index=0,
                          use_lovasz=lovasz, lovasz_weight=1.5,
                          class_weights=None if weights is None else
                          torch.from_numpy(weights), mean_over_all=over_all)
    got.backward()
    _close(got.detach(), want, 1e-6)
    _close(lt.grad, jgrad, 1e-6)


# ---------------------------------------------------------------------------
# samplers with JAX's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fps", "voxel", "curve"])
def test_samplers_with_jax_draws(kind):
    pos, _, cid, valid = lidar(1024, batch=2, seed=4)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 5)
    tp, tc, tv = map(torch.from_numpy, (pos, cid, valid))
    jp, jc, jv = map(jnp.asarray, (pos, cid, valid))
    if kind == "fps":
        want = jax.jit(lambda *a: jsmp.fps(*a, 0.3, key=key, budget=200))(
            jp, jv)
        u = jax.random.uniform(key, (2,))
        got = sampling.fps(tp, tv, 0.3, 200, u=torch.from_numpy(np.array(u)))
    elif kind == "voxel":
        want = jax.jit(lambda *a: jsmp.voxel_downsample(
            *a, 0.03, 600, key=key))(jp, jv)
        u = jax.random.uniform(key, (2, 1024))
        got = sampling.voxel_downsample(tp, tv, 0.03, 600,
                                        u=torch.from_numpy(np.array(u)))
    else:
        # eager: under jit XLA rounds the phase (start * 117 * u mod
        # spacing) differently, and the port follows the eager rounding
        want = jsmp.curve_fps(jp, jc, jv, 0.007, 700, key=key)
        u = jax.random.uniform(key, ())
        got = sampling.curve_fps(tp, tc, tv, 0.007, 700,
                                 u=torch.from_numpy(np.array(u)))
    deterministic = {"fps": lambda: sampling.fps(tp, tv, 0.3, 200),
                     "voxel": lambda: sampling.voxel_downsample(tp, tv, 0.03,
                                                                600),
                     "curve": lambda: sampling.curve_fps(tp, tc, tv, 0.007,
                                                         700)}
    assert not np.array_equal(deterministic[kind]()[0].numpy(),
                              np.asarray(want[0]))   # the draws matter
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


# ---------------------------------------------------------------------------
# K4 / K4b
# ---------------------------------------------------------------------------


def test_gather_refs_match_pallas_interpret():
    rng = np.random.default_rng(5)
    n, k, c = 256, 9, 24
    src = rng.normal(size=(n, c)).astype(np.float32)
    # a curve-ordered self-row kNN-like table (few unique rows per tile:
    # no spill), with -1 slots
    idx = np.clip(np.arange(n)[None, :] + rng.integers(-6, 7, size=(k, n)),
                  0, n - 1).astype(np.int32)
    idx[rng.random((k, n)) < 0.1] = -1
    cot = rng.normal(size=(k, n, c)).astype(np.float32)

    def f(s):
        return jnp.sum(pallas_gather.gather_rows(s, jnp.asarray(idx),
                                                 interpret=True) * cot)

    want = pallas_gather.gather_rows(jnp.asarray(src), jnp.asarray(idx),
                                     interpret=True)
    jgrad = jax.grad(f)(jnp.asarray(src))
    ts = torch.from_numpy(src)[None].requires_grad_(True)
    ti = torch.from_numpy(idx)[None]
    got = gather.gather_rows_km(ts, ti, fill=False)
    np.testing.assert_array_equal(got[0].detach().numpy(), np.asarray(want))
    (got[0] * torch.from_numpy(cot)).sum().backward()
    _close(ts.grad[0], jgrad, 1e-5)
    # fill: -1 slots read zeros and scatter nothing
    filled = gather.gather_km_ref(ts.detach(), ti, fill=True)[0].numpy()
    np.testing.assert_array_equal(filled, np.where(idx[..., None] >= 0,
                                                   np.asarray(want), 0))
    back = gather.scatter_km_ref(torch.from_numpy(cot)[None], ti, n, True)[0]
    want_back = np.zeros((n, c), np.float32)
    np.add.at(want_back, idx[idx >= 0], cot[idx >= 0])
    _close(back, want_back, 1e-5)


def test_gather_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    src = torch.randn(2, 7, 3, dtype=torch.float64, generator=g,
                      requires_grad=True)
    idx = torch.randint(-1, 7, (2, 4, 7), generator=g)
    for fill in (True, False):
        assert torch.autograd.gradcheck(
            lambda s: gather.gather_rows_km(s, idx, fill), (src,))


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

K7_CASES = [("attend", 1, 48, 10, (8, 12, 16), 16),
            ("attend", 2, 40, 15, (8, 16), 8),
            ("max", 1, 48, 10, (8, 12, 16), 0),
            ("max", 2, 40, 6, (8, 16), 0)]


def _k7_inputs(b, m, k, dims, a, seed=0):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(b, k, m, dims[0])).astype(np.float32)
    mask = rng.random((b, m, k)) > 0.25
    mask[0, 3, :] = False     # a fully masked query row
    mask[0, 5, :] = True
    params = []
    f32 = lambda t: t.astype(np.float32)  # noqa: E731
    for i in range(len(dims) - 1):
        params += [f32(1 + 0.2 * rng.normal(size=dims[i])),
                   f32(0.1 * rng.normal(size=dims[i])),
                   f32(0.3 * rng.normal(size=(dims[i], dims[i + 1]))),
                   f32(0.1 * rng.normal(size=dims[i + 1]))]
    if a:
        co = dims[-1]
        params += [f32(0.3 * rng.normal(size=(co, a))),
                   f32(0.1 * rng.normal(size=a)),
                   f32(1 + 0.2 * rng.normal(size=a)),
                   f32(0.1 * rng.normal(size=a)),
                   f32(0.3 * rng.normal(size=(a, co))),
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


def _port_k7(h1, mask, params, cfg, r, row_valid, dtype=torch.float32):
    th1 = torch.tensor(h1, dtype=dtype, requires_grad=True)
    tps = [torch.tensor(p, dtype=dtype, requires_grad=True) for p in params]
    out, n, *flat = group_train._GroupTrain.apply(
        cfg, th1, torch.from_numpy(mask), *tps)
    (out * torch.tensor(r, dtype=dtype) * row_valid[..., None]).sum().backward()
    return out.detach(), flat, th1.grad, [p.grad for p in tps]


@pytest.mark.parametrize("aggr,b,m,k,dims,a", K7_CASES)
def test_k7_plain_matches_pallas_interpret(aggr, b, m, k, dims, a):
    h1, mask, params, r = _k7_inputs(b, m, k, dims, a)
    n_loc = len(dims) - 1
    row_valid = mask.any(-1).astype(np.float32)
    loc, att = _jax_pdicts(params, n_loc, aggr == "attend")

    def jloss(h, loc_, att_):
        out, ls, ast = grouped_train_reduce(
            h, jnp.asarray(mask), loc_, n_loc + 1, att_, 2 if att_ else 0,
            aggr=aggr, interpret=True, tile_m=128)
        return jnp.sum(out * r * row_valid[..., None]), (out, ls, ast)

    (_, (jout, ls, ast)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(h1), loc, att)
    cfg = group_train.TrainCfg(dims=dims, att_dim=a, aggr=aggr,
                               act="leaky_relu")
    out, flat, gh1, gps = _port_k7(h1, mask, params, cfg, r,
                                   torch.from_numpy(row_valid))
    rv = row_valid[..., None] > 0
    _close(np.where(rv, out.numpy(), 0), np.where(rv, np.asarray(jout), 0),
           2e-5)
    for i, (mu, var, _) in enumerate(list(ls) + list(ast)):
        _close(flat[2 * i], mu, 1e-5)
        _close(flat[2 * i + 1], var, 1e-5)
    scale = lambda t: max(1.0, float(np.abs(np.asarray(t)).max()))  # noqa
    jh1 = np.asarray(jg[0])
    assert np.abs(gh1.numpy() - jh1).max() <= 5e-4 * scale(jh1)
    jloc, jatt = jg[1], jg[2]
    want = []
    for i in range(n_loc):
        want += [jloc[f"norm_{i}"]["scale"], jloc[f"norm_{i}"]["bias"],
                 jloc[f"lin_{i + 1}"]["kernel"], jloc[f"lin_{i + 1}"]["bias"]]
    if aggr == "attend":
        want += [jatt["lin_0"]["kernel"], jatt["lin_0"]["bias"],
                 jatt["norm_0"]["scale"], jatt["norm_0"]["bias"],
                 jatt["lin_1"]["kernel"], jatt["lin_1"]["bias"]]
    for j, (got, w) in enumerate(zip(gps, want)):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 5e-4 * scale(w), j


def _materialized(h1, mask, params, cfg):
    """Torch autograd of the materialized chain: two-pass masked BN over
    (B, K, M) rows, then the port's aggregation."""
    from curvecloudnet_tpu_torch.ops.aggregate import masked_attend

    mk = mask.transpose(1, 2)
    n = mk.sum().clamp(min=1)

    def bn(v, g, b):
        mu = (v * mk[..., None]).sum((0, 1, 2)) / n
        var = ((v - mu) ** 2 * mk[..., None]).sum((0, 1, 2)) / n
        return (v - mu) * torch.rsqrt(var + cfg.eps) * g + b

    act = lambda x: torch.where(x > 0, x, 0.01 * x)  # noqa: E731
    v = h1
    for i in range(cfg.n_loc):
        g, be, w, b = params[4 * i:4 * i + 4]
        v = act(bn(v, g, be)) @ w + b
    if cfg.attend:
        wa0, ba0, ga, ba, wa1, ba1 = params[4 * cfg.n_loc:]
        logits = act(bn(v @ wa0 + ba0, ga, ba)) @ wa1 + ba1
        return masked_attend(v.transpose(1, 2), logits.transpose(1, 2), mask)
    filled = torch.where(mask.transpose(1, 2)[..., None], v,
                         torch.full_like(v, -100.0))
    return torch.amax(filled, dim=1)   # ties share the gradient, as K7's cnt


@pytest.mark.parametrize("aggr,b,m,k,dims,a", K7_CASES[::2])
def test_k7_plain_matches_torch_autograd(aggr, b, m, k, dims, a):
    h1, mask, params, r = _k7_inputs(b, m, k, dims, a, seed=1)
    row_valid = torch.from_numpy(mask.any(-1).astype(np.float32))
    cfg = group_train.TrainCfg(dims=dims, att_dim=a, aggr=aggr,
                               act="leaky_relu")
    out, _, gh1, gps = _port_k7(h1, mask, params, cfg, r, row_valid)
    th1 = torch.tensor(h1, requires_grad=True)
    tps = [torch.tensor(p, requires_grad=True) for p in params]
    want = _materialized(th1, torch.from_numpy(mask), tps, cfg)
    (want * torch.from_numpy(r) * row_valid[..., None]).sum().backward()
    rv = row_valid[..., None] > 0
    _close(torch.where(rv, out, 0), torch.where(rv, want.detach(), 0), 2e-5)
    for got, w in [(gh1, th1.grad)] + list(zip(gps, [p.grad for p in tps])):
        assert (got - w).abs().max() <= 5e-4 * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("aggr", ["attend", "max"])
def test_k7_gradcheck_float64(aggr):
    a = 4 if aggr == "attend" else 0
    h1, mask, params, _ = _k7_inputs(1, 6, 4, (3, 5, 4), a, seed=2)
    cfg = group_train.TrainCfg(dims=(3, 5, 4), att_dim=a, aggr=aggr,
                               act="leaky_relu")
    tm = torch.from_numpy(mask)
    inputs = [torch.tensor(t, dtype=torch.float64, requires_grad=True)
              for t in [h1] + params]

    def f(h, *ps):
        out = group_train._GroupTrain.apply(cfg, h, tm, *ps)[0]
        return out * tm.any(-1)[..., None]

    assert torch.autograd.gradcheck(f, inputs, atol=1e-6, rtol=1e-4)


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_matches_optax(wd):
    rng = np.random.default_rng(6)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=5).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-4]
    tx = (optax.adam(lambda c: jnp.asarray(lrs)[c]) if wd == 0 else
          optax.adamw(lambda c: jnp.asarray(lrs)[c], weight_decay=wd))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    mod = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v))
                                  for k, v in p0.items()})
    opt = trainer.create_optimizer(mod, weight_decay=wd)
    for g, lr in zip(grads, lrs):
        for k, p in mod.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    for k, p in mod.items():
        _close(p.detach(), jp[k], 1e-6)


@pytest.mark.parametrize("cfg", [{"name": "exp", "lr_gamma": 0.96},
                                 {"name": "cosine", "T_0": 2, "T_mult": 2}])
def test_schedule_matches_optax(cfg):
    want = jtrainer.make_schedule(cfg, 5e-4, 3)
    got = trainer.make_schedule(cfg, 5e-4, 3)
    for count in range(0, 3 * 20):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=2e-6)
    assert trainer.bn_momentum_for_epoch(30) == \
        jtrainer.bn_momentum_for_epoch(30)
