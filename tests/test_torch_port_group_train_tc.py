"""K7's tensor-core design on the CPU (``ops/group_train.py``,
``csrc/group_train.cu``), held against the plain versions
``group_train_fwd_ref`` / ``group_train_bwd_ref``.

The model below is the kernels' arithmetic, step for step: the live
(plane, query) rows compacted once by ``group_train.row_list``, query-major;
every dense (forward, data gradient, weight gradient) a 3xTF32 product of
operands split by ``group_reduce.tf32_split``; each level's pre-BN values
stored by the forward and read by the backward; batch statistics, the BN
backward's sums and bias gradients as per-64-row-tile partials, the weight
gradients as per-row-split partials (``group_train.wgrad_split``), all
summed in the fixed order of ``group_train.finalize_ref``; queries with no
live slot get no rows (-100 under max, 0 under attend) and a zero dout.

Tolerances: the forward (outputs at queries with a live slot, means and
variances) within 1e-5 of max(1, |plain|): 3xTF32 keeps each product to
~2^-21 relative and the sums run in f32, in another order than the plain
matmuls.  Gradients in relative L2 norm within 1e-4 plus 3x the plain
version's own change when h1 moves by 1e-5 relative (norms floored at
1e-3 of the call's largest, for tensors that are zero in exact
arithmetic): the largest differences, up to ~1e-4 of that floor, are the
gradients of the biases before a BN, zero in exact arithmetic, where the
model and the plain version each sit as far from a float64 run; act'
jumps at 0 and a max picks one of two near-equal slots, so a row within
rounding of such a point may take the other branch (the card's tests
take 1e-3 for that at full width).  The
weight gradient's partial sums over ~10^5 rows stay within 1e-6 of the
float64 sum, relative to sum |a| |d|.
"""

import numpy as np
import pytest
import torch

from curvecloudnet_tpu_torch.ops import group_train as G
from curvecloudnet_tpu_torch.ops.aggregate import MAX_FILL
from curvecloudnet_tpu_torch.ops.group_reduce import tf32_split

torch.set_num_threads(1)


def mm3(a, b):
    """a @ b in 3xTF32: lo*hi + hi*lo + hi*hi, each TF32 product exact in
    f32, summed in f32."""
    ah, al = tf32_split(a.contiguous())
    bh, bl = tf32_split(b.contiguous())
    return al @ bh + ah @ bl + ah @ bh


def tile_sums(*cols):
    """Per-64-row-tile column sums of each (R, C) array -> (tiles, sum C),
    one tile for no rows."""
    r = cols[0].shape[0]
    tiles = max(1, -(-r // G.TILE))
    return torch.stack([torch.cat([c[i * G.TILE:(i + 1) * G.TILE].sum(0)
                                   for c in cols]) for i in range(tiles)])


def wgrad(x, d):
    """(dW, db) from per-row-split partials of x^T d and of d."""
    r, c_in, c_out = x.shape[0], x.shape[1], d.shape[1]
    splits, rps = G.wgrad_split(r, c_in, c_out, 132)
    part = torch.stack([
        torch.cat([mm3(x[s * rps:(s + 1) * rps].t(), d[s * rps:(s + 1) * rps]),
                   d[s * rps:(s + 1) * rps].sum(0, keepdim=True)])
        for s in range(splits)])
    out = G.finalize_ref(part).view(c_in + 1, c_out)
    return out[:c_in], out[c_in]


def bn_parts(v, gam, bet, mu, inv, act):
    xh = (v - mu) * inv
    y = xh * gam + bet
    return xh, y, G._act(y, act)


def model_fwd(h1, mask, cfg, params):
    rows, qry, start = G.row_list(mask)
    r, c0 = rows.numel(), h1.shape[-1]
    n = float(max(r, 1))
    st, invs = [], []

    def statistics(v):
        c = v.shape[1]
        sums = G.finalize_ref(tile_sums(v, v * v))
        mu = sums[:c] / n
        var = torch.clamp(sums[c:] / n - mu * mu, min=0.0)
        st.append((mu, var))
        invs.append(torch.rsqrt(var + cfg.eps))

    v = [h1.reshape(-1, c0)[rows.long()]]
    statistics(v[0])
    for lv in range(cfg.n_loc):
        g, bt, w, b = G._local(cfg, params, lv)
        u = bn_parts(v[lv], g, bt, st[lv][0], invs[lv], cfg.act)[2]
        v.append(mm3(u, w) + b)
        if lv + 1 < cfg.n_loc:
            statistics(v[-1])
    msg = v[-1]
    b_, m, k = mask.shape
    q, cl = b_ * m, msg.shape[1]
    live = (start[1:] - start[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(q), live)
    out = torch.zeros(q, cl)
    if cfg.attend:
        wa0, ba0, ga, bta, wa1, ba1 = G._att(cfg, params)
        gv = mm3(msg, wa0) + ba0
        statistics(gv)
        lg = mm3(bn_parts(gv, ga, bta, st[-1][0], invs[-1],
                          cfg.attend_act)[2], wa1) + ba1
        v += [gv, lg]
        mx = torch.full((q, cl), -500.0).scatter_reduce_(
            0, seg[:, None].expand(-1, cl), lg, "amax", include_self=False)
        e = torch.exp(lg - mx[seg])
        den = torch.zeros(q, cl).index_add_(0, seg, e)
        aux = torch.where((live == 0)[:, None], 1.0, den)
        out = out.index_add_(0, seg, e * msg) / aux
    else:
        fill = torch.where(live < k, MAX_FILL, -float("inf"))
        mx = fill[:, None].expand(q, cl).clone().scatter_reduce_(
            0, seg[:, None].expand(-1, cl), msg, "amax")
        aux = torch.zeros(q, cl).index_add_(0, seg, (msg == mx[seg]).float())
        aux += torch.where(mx == MAX_FILL, (k - live)[:, None].float(), 0.0)
        out = mx
    shape = (b_, m, cl)
    return (out.view(shape), st, torch.tensor(n),
            (rows, qry, out.view(shape), mx.view(shape), aux.view(shape),
             *v[1:], *invs))


def model_bwd(h1, mask, cfg, params, stats, extras, dout):
    rows, qry, out, mx, aux = extras[:5]
    L = cfg.n_loc
    n_vals = L + 2 * cfg.attend
    vals, invs = extras[5:5 + n_vals], extras[5 + n_vals:]
    r, c0 = rows.numel(), h1.shape[-1]
    n = float(max(r, 1))
    v = [h1.reshape(-1, c0)[rows.long()]] + list(vals[:L])
    cl = v[L].shape[1]
    qi = qry.long()
    d_q = dout.reshape(-1, cl)[qi]
    mx_q, aux_q, out_q = (t.reshape(-1, cl)[qi] for t in (mx, aux, out))
    grads = [None] * cfg.n_params

    def level(d, w, gam, bet, mu, inv, act, x):
        """data gradient and BN backward sums of the level below d."""
        xh, y, u = bn_parts(x, gam, bet, mu, inv, act)
        t = mm3(d, w.t()) * G._dact(y, act)
        sums = G.finalize_ref(tile_sums(t, t * xh))
        c = t.shape[1]
        rs, rp = sums[:c], sums[c:]
        dv = gam * inv * (t - (rs / n + xh * (rp / n)))
        return dv, rs, rp, u

    if cfg.attend:
        wa0, ba0, ga, bta, wa1, ba1 = G._att(cfg, params)
        gv, lg = vals[L], vals[L + 1]
        w_sm = torch.exp(lg - mx_q) / aux_q
        dl = w_sm * (v[L] - out_q) * d_q
        dg1, rsa, rpa, ua = level(dl, wa1, ga, bta, stats[L][0], invs[L],
                                  cfg.attend_act, gv)
        dwa1, dba1 = wgrad(ua, dl)
        dv = w_sm * d_q + mm3(dg1, wa0.t())
        dwa0, dba0 = wgrad(v[L], dg1)
        grads[4 * L:] = [dwa0, dba0, rpa, rsa, dwa1, dba1]
    else:
        dv = torch.where(v[L] == mx_q, d_q / torch.clamp(aux_q, min=1.0), 0.0)
    for lv in reversed(range(L)):
        g, bt, w, _ = G._local(cfg, params, lv)
        dv_in = dv
        dv, rs, rp, u = level(dv_in, w, g, bt, stats[lv][0], invs[lv],
                              cfg.act, v[lv])
        dw, db = wgrad(u, dv_in)
        grads[4 * lv:4 * lv + 4] = [rp, rs, dw, db]
    d_h1 = torch.zeros_like(h1)
    d_h1.view(-1, c0).index_copy_(0, rows.long(), dv)
    return d_h1, tuple(grads)


def _case(aggr, k, m, dims, a, live, seed=0, b=1):
    """numpy draws: h1, a mask with a live fraction of the slots and 5% of
    the queries with no live slot, params, and a dout that is 0 at those
    queries (as every consumer's, which masks them by row validity)."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    h1 = f32(rng.normal(size=(b, k, m, dims[0])))
    mask = rng.random((b, m, k)) < live
    mask[rng.random((b, m)) < 0.05] = False
    params = []
    for ci, co in zip(dims[:-1], dims[1:]):
        params += [f32(0.5 + rng.random(ci)), f32(0.1 * rng.normal(size=ci)),
                   f32(rng.normal(size=(ci, co)) / ci ** 0.5),
                   f32(0.1 * rng.normal(size=co))]
    if a:
        co = dims[-1]
        params += [f32(rng.normal(size=(co, a)) / co ** 0.5),
                   f32(0.1 * rng.normal(size=a)), f32(0.5 + rng.random(a)),
                   f32(0.1 * rng.normal(size=a)),
                   f32(rng.normal(size=(a, co)) / a ** 0.5),
                   f32(0.1 * rng.normal(size=co))]
    mask = torch.from_numpy(mask)
    dout = f32(rng.normal(size=(b, m, dims[-1]))) * mask.any(-1)[..., None]
    cfg = G.TrainCfg(dims=dims, att_dim=a, aggr=aggr, act="leaky_relu")
    return cfg, h1, mask, params, dout


def _rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


# aggr, K, M, widths, attention width, live fraction: the sites' K (21,
# 25, 32) and aggregations, sa-geo-like sparse masks (~3.6 live slots of
# 25), dense ones
CASES = [
    ("attend", 25, 300, (16, 24, 32, 40), 40, 0.144),
    ("attend", 32, 120, (24, 24, 24), 12, 0.6),
    ("max", 21, 200, (16, 16, 16), 0, 0.7),
    ("max", 32, 90, (32, 48, 32), 0, 0.45),
    ("max", 25, 300, (16, 24), 0, 0.144),
    ("attend", 21, 150, (8, 16), 16, 0.5),
]


@pytest.mark.parametrize("aggr,k,m,dims,a,live", CASES)
def test_k7_tc_model_matches_plain(aggr, k, m, dims, a, live):
    cfg, h1, mask, params, dout = _case(aggr, k, m, dims, a, live)
    dead = ~mask.any(-1)
    assert bool(dead.any()) and not bool(dout[dead].any())
    out, stats, n, extras = model_fwd(h1, mask, cfg, params)
    r_out, r_stats, r_n, r_extras = G.group_train_fwd_ref(h1, mask, cfg,
                                                          params)
    assert float(n) == float(r_n)
    rows = ~dead
    assert _rel(out[rows], r_out[rows]) <= 1e-5
    if aggr == "max":
        assert bool((out[dead] == MAX_FILL).all())
    for (mu, var), (r_mu, r_var) in zip(stats, r_stats):
        assert _rel(mu, r_mu) <= 1e-5 and _rel(var, r_var) <= 1e-5
    d_h1, grads = model_bwd(h1, mask, cfg, params, stats, extras, dout)
    r_h1, r_grads = G.group_train_bwd_ref(h1, mask, cfg, params, r_stats, r_n,
                                          r_extras, dout)
    g = torch.Generator().manual_seed(1)
    h1_s = h1 * (1 + 1e-5 * torch.randn(h1.shape, generator=g))
    s_h1, s_grads = G.group_train_bwd_ref(
        h1_s, mask, cfg, params, *G.group_train_fwd_ref(h1_s, mask, cfg,
                                                        params)[1:], dout)
    wants = (r_h1,) + tuple(r_grads)
    floor = 1e-3 * max(float(t.norm()) for t in wants)
    for got, want, shaken in zip((d_h1,) + tuple(grads), wants,
                                 (s_h1,) + tuple(s_grads)):
        assert got.shape == want.shape
        scale = max(float(want.norm()), floor)
        assert (float((got - want).norm())
                <= 1e-4 * scale + 3 * float((shaken - want).norm()))
    # rows that are not live get d_h1 = 0, as the plain version gives them
    assert not bool(d_h1.transpose(1, 2)[~mask].any())


def test_k7_weight_gradient_long_row_reduction():
    """~10^5 rows: the per-split 3xTF32 partials summed in the fixed order
    against the float64 sum."""
    rng = np.random.default_rng(3)
    r = 100003
    x = torch.from_numpy(rng.normal(size=(r, 16)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(r, 8)).astype(np.float32))
    dw, db = wgrad(x, d)
    splits, rps = G.wgrad_split(r, 16, 8, 132)
    assert splits > 100 and rps % G.STAGE == 0 and (splits - 1) * rps < r
    exact = x.double().t() @ d.double()
    mag = x.double().abs().t() @ d.double().abs()
    assert float(((dw.double() - exact).abs() / mag).max()) <= 1e-6
    assert float(((db.double() - d.double().sum(0)).abs()
                  / d.double().abs().sum(0)).max()) <= 1e-6


def test_row_list_is_query_major():
    rng = np.random.default_rng(5)
    mask = torch.from_numpy(rng.random((2, 7, 5)) < 0.4)
    mask[1, 3] = False
    rows, qry, start = G.row_list(mask)
    want_rows, want_q, want_start = [], [], [0]
    for b in range(2):
        for m in range(7):
            for k in range(5):
                if mask[b, m, k]:
                    want_rows.append((b * 5 + k) * 7 + m)
                    want_q.append(b * 7 + m)
            want_start.append(len(want_rows))
    assert rows.dtype == qry.dtype == start.dtype == torch.int32
    assert rows.tolist() == want_rows and qry.tolist() == want_q
    assert start.tolist() == want_start
    empty = G.row_list(torch.zeros(1, 3, 4, dtype=torch.bool))
    assert empty[0].numel() == 0 and empty[2].tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("rows,c_in,c_out", [(81153, 64, 128),
                                             (7595, 1024, 1024), (0, 64, 64),
                                             (100, 256, 256)])
def test_wgrad_split_covers_rows(rows, c_in, c_out):
    splits, rps = G.wgrad_split(rows, c_in, c_out, 132)
    assert splits >= 1 and rps % G.STAGE == 0
    assert splits * rps >= rows and (splits - 1) * rps < max(rows, 1)
    tiles = -(-c_in // G.TILE) * -(-c_out // G.TILE)
    assert splits == 1 or rps >= G._WG_MIN_ROWS - G.STAGE
    assert splits * tiles <= G._WG_BLOCKS_PER_SM * 132 + tiles


def test_finalize_order_is_fixed():
    """finalize_ref sums lane l's rows l, l + 8, ... then the lanes in
    order: equal to that loop written out, and within f32 rounding of the
    plain sum."""
    rng = np.random.default_rng(6)
    part = torch.from_numpy(rng.normal(size=(37, 3, 5)).astype(np.float32))
    got = G.finalize_ref(part)
    flat = part.reshape(37, 15).numpy()
    want = np.zeros(15, np.float32)
    for lane in range(8):
        acc = np.zeros(15, np.float32)
        for p in range(lane, 37, 8):
            acc = acc + flat[p]
        want = acc if lane == 0 else want + acc
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), flat.sum(0), rtol=1e-5,
                               atol=1e-5)


def test_gemm_slots_match_c_order():
    """``_GEMM_PTRS`` / ``_GEMM_INTS`` name the slots of ``ccn_gt_gemm``
    and ``ccn_gtw_gemm`` in the order ``csrc/group_train.cu`` reads them
    (``gt_job``, which both call): a swap would hand the kernel wrong
    operands that only the card's tests could catch."""
    import pathlib
    import re

    src = (pathlib.Path(G.__file__).parents[1] / "csrc" /
           "group_train.cu").read_text()
    for entry in ('extern "C" int ccn_gt_gemm', 'extern "C" int ccn_gtw_gemm'):
        call = src[src.index(entry):]
        assert "gt_job(ptrs, ints)" in call[:call.index("\n}\n")]
    body = src[src.index("static GJob gt_job("):]
    body = body[:body.index("\n}\n")]
    floats = re.findall(r"&j\.(\w+)", body[:body.index("};")])
    rest = {int(i or 0): name for name, i in
            re.findall(r"j\.(\w+) = \([^)]*\)ptrs\[nf(?: \+ (\d+))?\];",
                       body)}
    ptrs = floats + [rest[i] for i in range(len(rest))]
    ints = {int(i): name for name, i in
            re.findall(r"j\.(\w+) = ints\[(\d+)\];", body)}
    assert len(floats) == 21 and len(rest) == 6
    assert tuple(ptrs) == G._GEMM_PTRS
    assert tuple(ints[i] for i in range(len(ints))) == G._GEMM_INTS
    # every pointer slot is a pointer field of GJob, every int an int
    struct = src[src.index("struct GJob {"):]
    struct = re.sub(r"//[^\n]*", "", struct[:struct.index("};")])
    fields = {}
    for decl in struct.split("{", 1)[1].split(";"):
        for name in decl.split(","):
            words = name.replace("*", " * ").split()
            if words:
                fields[words[-1]] = "*" in words
    assert all(fields[name] for name in G._GEMM_PTRS)
    assert not any(fields[name] for name in G._GEMM_INTS)


def test_launch_times_labels_every_launch(monkeypatch):
    """``launch_times`` keys every launch of a forward and a backward by
    (pass, site): the wrappers' kernel paths run on the CPU against a
    stand-in library and stand-in CUDA events of 1 ms each, so each key's
    time is its launch count."""
    from curvecloudnet_tpu_torch.ops import _build

    class Library:
        def __getattr__(self, name):
            return lambda *args: 0

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def elapsed_time(self, end):
            return 1.0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(G, "_dptr", lambda t: None)
    monkeypatch.setattr(G, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cfg = G.TrainCfg(dims=(8, 16, 16), att_dim=4, aggr="attend",
                     act="leaky_relu")
    h1 = torch.randn(1, 5, 9, 8)
    mask = torch.rand(1, 9, 5) < 0.5
    params = []
    for ci, co in zip(cfg.dims[:-1], cfg.dims[1:]):
        params += [torch.ones(ci), torch.zeros(ci), torch.ones(ci, co),
                   torch.zeros(co)]
    params += [torch.ones(16, 4), torch.zeros(4), torch.ones(4),
               torch.zeros(4), torch.ones(4, 16), torch.zeros(16)]
    G.group_train_fwd.launches = G.group_train_bwd.launches = 0
    with G.launch_times() as times:
        out, stats, _, extras = G._kernel_fwd(h1, mask, cfg, params)
        G._kernel_bwd(h1, mask, cfg, params, stats, extras,
                      torch.zeros_like(out))
    site = "attend (8, 16, 16) K=5 M=9"
    assert {s for _, s in times} == {site}
    assert {p for p, _ in times} == {"stats", "dense", "finalize",
                                     "aggregate", "dgrad", "wgrad"}
    assert sum(times.values()) == (G.group_train_fwd.launches +
                                   G.group_train_bwd.launches)
    assert G._timing is None
    G.group_train_fwd(h1, mask, cfg, params)     # no timing outside
    assert G._timing is None
