"""The bfloat16 variants of K1, K2, K4 and K9 against their plain versions,
on the card (a model with ``compute_dtype: bfloat16``).

A CUDA kernel has no CPU mode, so these tests skip without a GPU; with
one (and nvcc)::

    python -m pytest tests/test_torch_port_cuda_bf16.py -q

Kernel and plain version round at the same points (bfloat16 operands, f32
products and sums), so they differ only in the order of the f32 sums.
K2's output is f32 and its inter-layer roundings move it by far less than
a bfloat16 rounding: 2^-8 of max(1, max |plain|).  K1 rounds every layer's
output to bfloat16, where a sum-order difference flips a rounding now and
then: one bfloat16 ulp at max(1, max |plain|), and under 1% of the
elements differing at all.  K9 computes in f32 on bfloat16 rows: 1e-4 of
the largest value other than the -100 fill, as in f32.  K4 copies rows:
equal.  A narrow flagship in bfloat16 on the card: logits within the plain
path's own bfloat16-vs-float32 gap of the plain path's, and the per-step
dtypes of the CPU path.
"""

import math

import pytest
import torch
import yaml

from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.config import load_config
from curvecloudnet_tpu_torch.ops import (conv1d_chain, edge_mlp, gather,
                                         group_reduce)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bf16_ulp(scale: float) -> float:
    """One bfloat16 ulp at ``scale`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _scale(ref):
    return max(1.0, float(ref.float().abs().max()))


# the main path's step_31 (C0 262, h 2, three layers of 32; at the
# nuScenes sweep's size too), a ragged width and a wide layer
CHAIN_CASES = [(262, (32, 32, 32), 2, 3000, [2900, 1700]),
               (262, (32, 32, 32), 2, 49164, [30000, 49164]),
               (5, (16, 24), 1, 3000, [0, 119]),
               (40, (128, 72), 2, 1000, [700, 1000])]


@pytest.mark.parametrize("c0,dims,h,n_exp,used", CHAIN_CASES)
def test_conv1d_chain_bf16_kernel(dev, c0, dims, h, n_exp, used):
    g = torch.Generator().manual_seed(0)
    xe = torch.randn(2, n_exp, c0, generator=g).to(torch.bfloat16)
    weights, cin = [], c0
    for cout in dims:
        weights.append((torch.randn((h + 1) * cin, cout, generator=g)
                        / ((h + 1) * cin) ** 0.5,
                        0.1 * torch.randn(cout, generator=g)))
        cin = cout
    args = (xe.to(dev), tuple((w.to(dev), b.to(dev)) for w, b in weights),
            torch.tensor(used, dtype=torch.int32).to(dev), h)
    n0 = conv1d_chain.conv1d_chain_eval_bf16.launches
    got = conv1d_chain.conv1d_chain_eval(*args)
    assert conv1d_chain.conv1d_chain_eval_bf16.launches == n0 + 1
    want = conv1d_chain.conv1d_chain_eval_ref(*args)
    assert got.dtype == want.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= bf16_ulp(_scale(want))
    assert float((diff > 0).float().mean()) < 0.01
    # the live mask: slots past ``used`` are 0
    for b, u in enumerate(used):
        assert bool((got[b, u:] == 0).all())


GROUP_CASES = [
    ("max", 21, (64, 64, 64), None, 0.6, 3001),
    ("attend", 25, (64, 128, 192, 256), (256, 256, 256), 0.15, 2999),
    ("attend", 32, (512, 512, 512), (512, 256, 512), 0.8, 301),
    ("max", 32, (1024, 1024, 1024), None, 0.85, 203),
    ("max", 21, (36, 20, 44), None, 0.7, 517),
    ("attend", 25, (128,), (128, 64, 128), 0.3, 517),
    ("attend", 128, (128, 128, 128), (128, 128, 128), 0.3, 2017),
]


@pytest.mark.parametrize("aggr,k,widths,att,live,m", GROUP_CASES)
def test_group_reduce_bf16_kernel(dev, aggr, k, widths, att, live, m):
    g = torch.Generator().manual_seed(1)
    c1 = widths[0]
    h1 = torch.randn(1, k, m, c1, generator=g)
    mask = torch.rand(1, m, k, generator=g) < live
    mask[:, torch.rand(m, generator=g) < 0.05] = False
    padded = torch.nonzero(~mask[0].any(-1))[::2, 0]
    h1[0, :, padded] = h1[0, :1, padded]
    layers = lambda ws: tuple(  # noqa: E731
        (torch.randn(a, b, generator=g) / a ** 0.5,
         0.1 * torch.randn(b, generator=g)) for a, b in zip(ws[:-1], ws[1:]))
    if len(widths) == 1:
        aff, act = (torch.ones(c1), torch.zeros(c1)), "identity"
    else:
        aff = (0.5 + torch.rand(c1, generator=g),
               0.1 * torch.randn(c1, generator=g))
        act = "leaky_relu"
    move = lambda ls: None if ls is None else tuple(  # noqa: E731
        (w.to(dev), b.to(dev)) for w, b in ls)
    args = (h1.to(torch.bfloat16).to(dev), mask.to(dev),
            tuple(t.to(dev) for t in aff), move(layers(widths)),
            move(None if att is None else layers(att)))
    kw = dict(aggr=aggr, act=act)
    n0 = group_reduce.group_reduce_bf16.launches
    got = group_reduce.group_reduce(*args, **kw)
    assert group_reduce.group_reduce_bf16.launches == n0 + 1
    want = group_reduce.group_reduce_ref(*args, **kw)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 2.0 ** -8 * _scale(want), err
    dead = ~mask.any(-1).to(dev)
    if aggr == "max":
        assert bool((got[dead] == -100.0).all())
    with pytest.raises(ValueError, match="bfloat16"):
        group_reduce.group_reduce_bf16(args[0].float(), *args[1:], **kw)


@pytest.mark.parametrize("c,fill", [(64, True), (1024, False), (35, True),
                                    (67, False)])
def test_gather_bf16_kernel(dev, c, fill):
    g = torch.Generator().manual_seed(5)
    n, k = 3000, 21
    src = torch.randn(2, n, c, generator=g).to(torch.bfloat16).to(dev)
    idx = torch.randint(-1, n, (2, k, n), generator=g,
                        dtype=torch.int32).to(dev)
    n0 = gather.gather_km_bf16.launches
    got = gather.gather_km(src, idx, fill)
    assert gather.gather_km_bf16.launches == n0 + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, gather.gather_km_ref(src, idx, fill))


@pytest.mark.parametrize("c,widths", [(67, (64, 64, 64)), (131, (128, 128)),
                                      (5, (7,))])
def test_edge_mlp_bf16_rows(dev, c, widths):
    g = torch.Generator().manual_seed(9)
    n, k = 700, 21
    x = torch.randn(2, n, c, generator=g).to(torch.bfloat16)
    idx = torch.randint(0, n, (2, n, k), generator=g, dtype=torch.int32)
    idx[:, :, 0] = torch.arange(n, dtype=torch.int32)
    idx[torch.rand(2, n, k, generator=g) < 0.3] = -1
    idx[:, 600:] = -1
    dims = (2 * c,) + widths
    weights = tuple(torch.randn(a, b, generator=g) / a ** 0.5
                    for a, b in zip(dims[:-1], dims[1:]))
    biases = tuple(0.1 * torch.randn(b, generator=g) for b in widths)
    args = (x.to(dev), idx.to(dev), tuple(w.to(dev) for w in weights),
            tuple(b.to(dev) for b in biases))
    n0 = edge_mlp.fused_edge_mlp_max_bf16.launches
    got = edge_mlp.fused_edge_mlp_max(*args)
    assert edge_mlp.fused_edge_mlp_max_bf16.launches == n0 + 1
    want = edge_mlp.fused_edge_mlp_max_ref(*args)
    # the same as the f32 kernel on the widened rows
    f32 = edge_mlp.fused_edge_mlp_max(args[0].float(), *args[1:])
    assert got.dtype == torch.float32 and torch.equal(got, f32)
    assert bool((got[:, 600:] == -100.0).all())
    rest = want[want != -100.0]
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(rest.abs().max()))


def _bf16_config(tmp_path):
    cfg = load_config("configs/nuscenes.yaml")
    cfg["model"]["compute_dtype"] = "bfloat16"
    path = tmp_path / "nuscenes_bf16.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("route", ["group", "fused"])
def test_small_bf16_scan_matches_plain_path(dev, tmp_path, route):
    """The flagship at n_pad 2048 in bfloat16: the kernel path against the
    plain path on the card, within the plain path's bf16-vs-f32 gap."""
    from curvecloudnet_tpu_torch.models import modules

    path = _bf16_config(tmp_path)
    scan = tuple(t.to(dev) for t in predict.synthetic_scan(0, 2048, "cpu"))
    model = predict.build_model(path, 2048, dev, edge_kernel=route)
    f32 = predict.build_model("configs/nuscenes.yaml", 2048, dev,
                              edge_kernel=route)
    got = predict.predict(model, *scan)[0]
    assert got.dtype == torch.bfloat16
    plain = {}
    for name, m in (("bf16", model), ("f32", f32)):
        with _plain_kernels():
            plain[name] = predict.predict(m, *scan)[0].float()
    valid = scan[3]
    err = float((got.float() - plain["bf16"])[valid].abs().max())
    gap = float((plain["bf16"] - plain["f32"])[valid].abs().max())
    assert 0 < gap and err <= gap, (err, gap)
    assert modules.compute_dtype(model.spec) == torch.bfloat16


class _plain_kernels:
    """Every eval wrapper replaced by its plain version."""

    PAIRS = [(conv1d_chain, "conv1d_chain_eval", "conv1d_chain_eval_ref"),
             (group_reduce, "group_reduce", "group_reduce_ref"),
             (gather, "gather_km", "gather_km_ref"),
             (edge_mlp, "fused_edge_mlp_max", "fused_edge_mlp_max_ref")]

    def __enter__(self):
        from curvecloudnet_tpu_torch.ops import fps, knn

        self.pairs = self.PAIRS + [(knn, "knn_search", "knn_search_ref"),
                                   (fps, "fps_picks", "fps_picks_ref")]
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.pairs]
        for m, n, r in self.pairs:
            setattr(m, n, getattr(m, r))
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


# --- the bfloat16 train kernels: K7, K8 (fwd and t) and K4b -------------
#
# Kernel and plain version round at the same points, so they differ by
# the order of the f32 sums, which now and then flips a bfloat16 rounding
# of an operand: forward outputs and statistics within 2^-8 of their
# largest value; backward outputs within 2^-7 in relative L2 norm plus
# twice the plain version's own bf16-vs-f32 change (norms floored at 2^-8
# of the call's largest): a gradient that is 0 in exact arithmetic (a
# bias feeding a BatchNorm) is the sum of K7's bfloat16 roundings of T,
# so one flipped rounding moves it by a share of its own size; K4b
# within 2^-8 of its largest.

BF16_REL = 2.0 ** -8


def _max_rel(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / float(
        want.abs().max().clamp(min=1e-30))


def _l2_all(outs, tol):
    """[(kernel, plain bf16, plain f32)] -> each kernel output within
    ``tol`` plus twice the plain versions' own gap, in relative L2."""
    floor = BF16_REL * max(float(w.float().norm()) for _, w, _ in outs)
    for i, (got, want, w32) in enumerate(outs):
        scale = max(float(want.float().norm()), floor)
        rel = float((got.float() - want.float()).norm()) / scale
        gap = float((want.float() - w32.float()).norm()) / scale
        assert bool(torch.isfinite(got.float()).all()) and \
            rel <= tol + 2 * gap, (i, rel, gap)


@pytest.mark.parametrize("c,fill", [(64, True), (35, False)])
def test_scatter_bf16_kernel(dev, c, fill):
    g = torch.Generator().manual_seed(5)
    b, n, k = 1, 3000, 20
    d_out = torch.randn(b, k, n, c, generator=g).to(torch.bfloat16).to(dev)
    idx = torch.randint(-1, n, (b, k, n), generator=g).to(dev)
    n0 = gather.scatter_km_bf16.launches
    got = gather.scatter_km(d_out, idx, n, fill)
    assert gather.scatter_km_bf16.launches == n0 + 1
    want = gather.scatter_km_ref(d_out, idx, n, fill)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _max_rel(got, want) <= BF16_REL
    assert float((got != want).float().mean()) < 0.01


def _train_cfg_params(dims, att, g):
    from curvecloudnet_tpu_torch.ops import group_train as G

    cfg = G.TrainCfg(dims=dims, att_dim=att, aggr="attend" if att else "max",
                     act="leaky_relu")
    params = []
    for ci, co in zip(dims[:-1], dims[1:]):
        params += [1 + 0.2 * torch.randn(ci, generator=g),
                   0.1 * torch.randn(ci, generator=g),
                   torch.randn(ci, co, generator=g) / ci ** 0.5,
                   0.1 * torch.randn(co, generator=g)]
    if att:
        co = dims[-1]
        params += [torch.randn(co, att, generator=g) / co ** 0.5,
                   0.1 * torch.randn(att, generator=g),
                   1 + 0.2 * torch.randn(att, generator=g),
                   0.1 * torch.randn(att, generator=g),
                   torch.randn(att, co, generator=g) / att ** 0.5,
                   0.1 * torch.randn(co, generator=g)]
    return cfg, params


# the flagship's sa-geo attend site, an sgcnn max site, shapenet-seg's
# 1024-wide attention
K7_CASES = [((14, 16, 24, 32), 32, 2048, 9), ((22, 64, 64), 0, 4096, 21),
            ((259, 512, 1024), 1024, 512, 9)]


@pytest.mark.parametrize("dims,att,m,k", K7_CASES)
def test_group_train_bf16_kernel(dev, dims, att, m, k):
    from curvecloudnet_tpu_torch.ops import group_train as G

    g = torch.Generator().manual_seed(7)
    cfg, params = _train_cfg_params(dims, att, g)
    h1 = (2 * torch.randn(1, k, m, dims[0], generator=g)).to(torch.bfloat16)
    mask = torch.rand(1, m, k, generator=g) < 0.6
    mask[0, :5] = False                      # queries with no live slot
    dout = torch.randn(1, m, dims[-1], generator=g) * mask.any(-1)[..., None]
    h1, mask, dout = h1.to(dev), mask.to(dev), dout.to(dev)
    params = [p.to(dev) for p in params]
    n0 = (G.group_train_fwd_bf16.launches, G.group_train_bwd_bf16.launches)
    out, stats, n, extras = G.group_train_fwd(h1, mask, cfg, params)
    d_h1, grads = G.group_train_bwd(h1, mask, cfg, params, stats, n, extras,
                                    dout)
    assert G.group_train_fwd_bf16.launches > n0[0]
    assert G.group_train_bwd_bf16.launches > n0[1]
    r_out, r_stats, r_n, r_extras = G.group_train_fwd_ref(h1, mask, cfg,
                                                          params)
    rows = mask.any(-1)
    assert out.dtype == torch.float32 and d_h1.dtype == torch.bfloat16
    assert _max_rel(out[rows], r_out[rows]) <= BF16_REL
    for (mu, var), (r_mu, r_var) in zip(stats, r_stats):
        assert _max_rel(mu, r_mu) <= BF16_REL
        assert _max_rel(var, r_var) <= BF16_REL
    r_h1, r_grads = G.group_train_bwd_ref(h1, mask, cfg, params, r_stats,
                                          r_n, r_extras, dout)
    h32 = h1.float()
    _, s32, n32, e32 = G.group_train_fwd_ref(h32, mask, cfg, params)
    f_h1, f_grads = G.group_train_bwd_ref(h32, mask, cfg, params, s32, n32,
                                          e32, dout)
    _l2_all(list(zip((d_h1,) + tuple(grads), (r_h1,) + tuple(r_grads),
                     (f_h1,) + tuple(f_grads))), 2 * BF16_REL)


# the main path's step_31 (xe 262 wide in bfloat16, h 2, three layers of
# 32) and a layer behind a BN with a wide output
K8_CASES = [(262, (32, 32, 32), 2, 6000, [5900, 3700]),
            (40, (64, 48), 1, 3000, [2000, 3000])]


@pytest.mark.parametrize("c0,dims,h,n_exp,used", K8_CASES)
def test_conv1d_train_bf16_kernel(dev, c0, dims, h, n_exp, used):
    from curvecloudnet_tpu_torch.ops import conv1d_train as C

    g = torch.Generator().manual_seed(9)
    xe = torch.randn(2, n_exp, c0, generator=g).to(torch.bfloat16)
    for i, u in enumerate(used):
        xe[i, u:] = 0
    params, cin = [], c0
    for cout in dims:
        params.append(((torch.randn((h + 1) * cin, cout, generator=g)
                        / ((h + 1) * cin) ** 0.5).to(dev),
                       (0.1 * torch.randn(cout, generator=g)).to(dev),
                       (1 + 0.2 * torch.randn(cout, generator=g)).to(dev),
                       (0.1 * torch.randn(cout, generator=g)).to(dev)))
        cin = cout
    xe = xe.to(dev)
    tu = torch.tensor(used, dtype=torch.int32).to(dev)
    z_prev, bn_prev = xe, None
    for li, (w, b, gam, bet) in enumerate(params):
        n0 = C.conv1d_train_fwd_layer_bf16.launches
        z, mean, var = C.conv1d_train_fwd_layer(z_prev, bn_prev, w, b, tu, h,
                                                True)
        assert C.conv1d_train_fwd_layer_bf16.launches == n0 + 1
        r_z, r_mean, r_var = C.conv1d_train_fwd_layer_ref(
            z_prev, bn_prev, w, b, tu, h, True)
        assert _max_rel(z, r_z) <= BF16_REL
        assert _max_rel(mean, r_mean) <= BF16_REL
        assert _max_rel(var, r_var) <= BF16_REL
        bn = (mean, torch.rsqrt(var + 1e-5), gam, bet)
        d_u = torch.randn(z.shape, generator=g).to(dev)
        c1, c2 = 0.01 * torch.randn(2, z.shape[-1], generator=g).to(dev)
        fuse = bn_prev is not None and z_prev.shape[-1] <= C.DW_FUSED
        n0 = C.conv1d_train_bwd_t_bf16.launches
        got = C.conv1d_train_bwd_t(d_u, z, z_prev, bn, bn_prev, w, c1, c2, tu,
                                   h, prev_sums=fuse, bf16=True)
        assert C.conv1d_train_bwd_t_bf16.launches == n0 + 1
        want = C.conv1d_train_bwd_t_ref(d_u, z, z_prev, bn, bn_prev, w, c1,
                                        c2, tu, h, prev_sums=fuse, bf16=True)
        w32 = C.conv1d_train_bwd_t_ref(d_u, z, z_prev.float(), bn, bn_prev, w,
                                       c1, c2, tu, h, prev_sums=fuse)
        pairs = list(zip(got[:3], want[:3], w32[:3]))
        if fuse:
            pairs += list(zip(got[3], want[3], w32[3]))
        assert got[0].dtype == torch.float32
        _l2_all(pairs, 2 * BF16_REL)
        z_prev, bn_prev = z, bn
