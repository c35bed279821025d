"""K9's and K5's designs on the CPU (``csrc/edge_mlp.cu``,
``csrc/group_chain.cuh``, ``csrc/grid_topk.cu``), held against their plain
versions and the JAX package.

K9.  The model below is the kernel's arithmetic, step for step: layer 0
projected once a point, [U | V] = x [Wt - Wb | Wb] + [0 | b_0]
(``edge_mlp.layer0_projection``, the wrapper's own packing) as a 3xTF32
product of operands split by ``group_reduce.tf32_split``; a block's
queries strided over N (``edge_mlp._chain_shape``'s queries a block),
their live (query, slot) rows compacted query-major and run in chunks of
R rows, each row starting as relu(U[j] + V[i]) (the identity for a
one-layer MLP), the later layers 3xTF32 products; the masked max carried
across a query's chunks, starting at -100 for a query with a dead slot; a
query with no live slot gets -100 and no row.  Held against
``fused_edge_mlp_max_ref`` within 1e-5 of max(1, |plain|) (the card's bar
is 1e-4: 3xTF32 keeps each product to ~2^-21, and the re-association of
layer 0 rounds x_j (Wt - Wb) + x_i Wb, not [x_j, x_i - x_j] W_0), and
against ``pallas_edge.fused_edge_mlp_max_single(interpret=True)`` at the
JAX test's 2e-4, in both message orders, at narrow and odd widths.

K5.  The model is the warp's scan order: a query's stencil rows in column
order, 32 records of a row at a time, each candidate through the r2 test
and the strict k-th reject, the survivors merged into the list on (d2,
candidate position = column x cap + slot), positions mapped back to point
indices at the end.  It must equal ``grid_topk_records_ref`` bit for bit,
on a tie-heavy table (lattice points at equal distances, the same point
in two stencil rows, records exactly at r2, rows longer than 32 records)
and on tables ``grid_knn`` builds.

K10.  The model is the warp's scan of a row: reads of 128 columns (a
float4 a lane, W % 4 == 0) or 32 (one value a lane) in column order, each
value through the fill test (< 0.98e30) and the strict reject v < k-th
value taken before the read, the survivors merged into the list on
(value, column), idx gathered at the k chosen columns at the end.  It must
equal ``topk_smallest_ref`` bit for bit (tie-heavy rows, rows of fills,
values at the fill limit, W % 4 != 0, k 1, 8, 16 and 32), and
``pallas_topk.topk_smallest(interpret=True)`` on values its quantization
leaves unchanged.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvecloudnet_tpu.ops import pallas_edge, pallas_topk
from curvecloudnet_tpu_torch.models.layers import MLP
from curvecloudnet_tpu_torch.ops import _build
from curvecloudnet_tpu_torch.ops import edge_mlp as E
from curvecloudnet_tpu_torch.ops import grid_knn, grid_topk
from curvecloudnet_tpu_torch.ops import group_reduce as G

torch.set_num_threads(1)


def mm3(a, w):
    """a @ w in 3xTF32: lo*hi + hi*lo + hi*hi, each term an f32 product of
    TF32 values."""
    ah, al = G.tf32_split(a)
    wh, wl = G.tf32_split(w)
    return (al @ wh) + (ah @ wl) + (ah @ wh)


def k9_model(x, nbr, weights, biases, sms=2):
    """K9's arithmetic -> (out (B, N, O), queries whose rows straddle two
    chunks)."""
    b, n, c = x.shape
    k = nbr.shape[2]
    wproj, bproj = E.layer0_projection(weights, biases)
    proj = (mm3(x.reshape(-1, c), wproj) + bproj).reshape(b, n, -1)
    h0 = wproj.shape[1] // 2
    u, v = proj[..., :h0], proj[..., h0:]
    later = list(zip(weights[1:], biases[1:]))
    dims = [h0] + [w.shape[1] for w in weights[1:]]
    rows, tq, _, _ = E._chain_shape(dims, k, b * n, sms)
    blocks = -(-n // tq)
    out = torch.empty((b, n, dims[-1]))
    straddled = 0
    for bi in range(b):
        for m0 in range(blocks):
            qs = torch.arange(m0, n, blocks)[:tq]
            live = nbr[bi, qs] >= 0                        # (nq, K)
            out[bi, qs[~live.any(1)]] = -100.0
            qq, kk = torch.nonzero(live, as_tuple=True)    # query-major
            state = {}
            for r0 in range(0, len(qq), rows):
                q_c, k_c = qq[r0:r0 + rows], kk[r0:r0 + rows]
                i = qs[q_c]
                h = u[bi, nbr[bi, i, k_c].long()] + v[bi, i]
                if later:
                    h = torch.clamp(h, min=0.0)
                for li, (w, bias) in enumerate(later):
                    h = mm3(h, w) + bias
                    if li < len(later) - 1:
                        h = torch.clamp(h, min=0.0)
                for q in torch.unique(q_c).tolist():
                    mine = h[q_c == q].amax(0)
                    if q in state:
                        straddled += 1
                        start = state[q]
                    elif bool(live[q].all()):
                        start = torch.full_like(mine, -float("inf"))
                    else:
                        start = torch.full_like(mine, -100.0)
                    state[q] = torch.maximum(start, mine)
            for q, val in state.items():
                out[bi, qs[q]] = val
    return out, straddled


def _edge_mlp(c, widths, seed):
    """An eval edge MLP (input 2C) with random weights and BN statistics;
    its last layer's channel 0 has bias -500 (live values below -100)."""
    g = torch.Generator().manual_seed(seed)
    mlp = MLP((2 * c,) + widths, use_bias=True).eval()
    with torch.no_grad():
        for li, lin in enumerate(mlp.lins):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g)
                             / lin.weight.shape[1] ** 0.5)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g))
            if li == len(mlp.lins) - 1:
                lin.bias[0] = -500.0
        for nrm in mlp.norms:
            for t, lo in ((nrm.weight, 0.5), (nrm.running_var, 0.2)):
                t.copy_(lo + torch.rand(t.shape, generator=g))
            for t in (nrm.bias, nrm.running_mean):
                t.copy_(torch.randn(t.shape, generator=g))
    return mlp


def _edge_inputs(c, n, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, n, c)).astype(np.float32)
    nbr = rng.integers(0, n, size=(2, n, k)).astype(np.int32)
    nbr[:, :, 0] = np.arange(n)              # self loops
    nbr[rng.random((2, n, k)) < 0.3] = -1    # dead slots
    nbr[:, n - 9:] = -1                      # padding queries: no live slot
    nbr[0, 5, 1:] = -1                       # a query with its self loop only
    nbr[1, 7, :] = nbr[1, 7, 0]              # a query with every slot live
    return x, nbr


# (C, widths): the card test's odd widths, a one-layer MLP, and the
# flagship's step_3 widths (C 67) narrowed
K9_CASES = [(5, (7,)), (5, (8, 7)), (67, (16, 16, 12))]


@pytest.mark.parametrize("c,widths", K9_CASES)
@pytest.mark.parametrize("slow", [False, True])
def test_k9_model_matches_plain_and_pallas(c, widths, slow):
    n, k = 150, 9
    x, nbr = _edge_inputs(c, n, k, seed=c + len(widths))
    mlp = _edge_mlp(c, widths, seed=len(widths))
    with torch.no_grad():
        weights, biases = E.fold_edge_mlp_eval(mlp, slow=slow)
        xt, nt = torch.from_numpy(x), torch.from_numpy(nbr)
        got, straddled = k9_model(xt, nt, weights, biases)
        want = E.fused_edge_mlp_max_ref(xt, nt, weights, biases)
    assert straddled > 0               # queries straddle two chunks
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), err
    # -100: queries with no live slot exactly; channel 0's live values
    # all lie below it, so queries with a dead slot read -100 there
    assert bool((got[:, n - 9:] == -100.0).all())
    dead = (nt < 0).any(-1)
    assert bool((got[..., 0][dead] == -100.0).all())
    assert bool((got[..., 0][~dead] < -100.0).all())
    jw = [jnp.asarray(w.detach().numpy()) for w in weights]
    jb = [jnp.asarray(bb.detach().numpy()) for bb in biases]
    jax_out = np.stack([np.asarray(pallas_edge.fused_edge_mlp_max_single(
        jnp.asarray(x[bi][np.maximum(nbr[bi], 0)]), jnp.asarray(x[bi]),
        jnp.asarray(nbr[bi] >= 0), tuple(jw), tuple(jb), interpret=True))
        for bi in range(2)])
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=2e-4, atol=2e-4)


def test_layer0_projection_is_the_message_product():
    """[U | V] rows recombine to [x_j, x_i - x_j] W_0 + b_0 (float64)."""
    g = torch.Generator().manual_seed(3)
    c, h = 67, 64
    w0 = torch.randn(2 * c, h, generator=g, dtype=torch.float64)
    b0 = torch.randn(h, generator=g, dtype=torch.float64)
    xi, xj = torch.randn(2, 5, c, generator=g, dtype=torch.float64)
    wproj, bproj = E.layer0_projection((w0,), (b0,))
    assert wproj.shape == (c, 2 * h) and bproj.shape == (2 * h,)
    wproj, bproj = wproj.double(), bproj.double()
    got = (xj @ wproj + bproj)[:, :h] + (xi @ wproj + bproj)[:, h:]
    want = torch.cat([xj, xi - xj], -1) @ w0 + b0
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_group_route_layer0_uses_the_same_split(bias):
    """``EdgeConvStep.layer0`` (the group route's two products) and K9's
    projection take W_0 apart the same way: x (Wt - Wb) and x Wb + b_0
    are the two halves of x [Wt - Wb | Wb] + [0 | b_0]; in the slow
    message order the gathered product is x Wb and the query's x (Wt - Wb)
    + b_0, whose sum is [x_i, x_j - x_i] W_0 + b_0."""
    from types import SimpleNamespace

    from curvecloudnet_tpu_torch.models.modules import EdgeConvStep

    torch.manual_seed(4)
    c, h = 5, 7
    mlp = MLP((2 * c, h, 3), use_bias=bias)
    x = torch.randn(2, 9, c)
    lin0 = mlp.lins[0]
    b0 = lin0.bias if bias else torch.zeros(h)
    with torch.no_grad():
        u, v = EdgeConvStep.layer0(SimpleNamespace(nn=mlp, slow=False), x)
        wproj, bproj = E.layer0_projection((lin0.weight.t(),), (b0,))
        want = x @ wproj + bproj
        su, sv = EdgeConvStep.layer0(SimpleNamespace(nn=mlp, slow=True), x)
        xi, xj = x[:, :, None], x[:, None]
        slow = torch.cat([xi.expand(-1, -1, 9, -1), xj - xi], -1) @ \
            lin0.weight.t() + b0
    torch.testing.assert_close(u, want[..., :h], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(v, want[..., h:], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(su[:, None] + sv[:, :, None], slow,
                               rtol=1e-5, atol=1e-5)


# (C, weight rows a stage): the flagship's admitted steps (3 and 28, 6,
# 22, 25), the card test's odd width, an input past the gate's 256
PROJECT_STAGES = [(67, 32), (131, 32), (256, 16), (128, 32), (5, 32),
                  (300, 8)]


@pytest.mark.parametrize("c,kc", PROJECT_STAGES)
def test_projection_launch_shape(c, kc):
    """The deepest weight stage whose buffers (the tile's EP_ROWS rows of x
    as f32, two stages of weight rows, each a hi and a lo image EP_LDW
    words wide) let EP_BLOCKS projection blocks share an SM's shared
    memory."""
    assert E._project_stage(c) == kc
    rows, blocks, ldw = E._PROJ_ROWS, E._PROJ_BLOCKS, E._PROJ_LDW
    ldx = G._round(G._round(c, 8), 32) + 4
    fit = _build.SM_SMEM // blocks - _build.BLOCK_RESERVED
    assert E._project_smem(c, kc) == 4 * (rows * ldx + 4 * kc * ldw)
    assert E._project_smem(c, kc) <= fit
    if kc < E._STAGE_ROWS[0]:
        assert E._project_smem(c, 2 * kc) > fit
    with pytest.raises(ValueError):
        E._project_stage(600)


def test_projection_tile_matches_the_kernel():
    """The wrapper's projection tile, blocks an SM and weight-stage stride
    are the kernel's EP_ROWS / EP_COLS / EP_BLOCKS / EP_LDW, and
    ``ccn_edge_mlp`` refuses a plan whose projection stage does not let
    EP_BLOCKS blocks share an SM."""
    src = (_build.CSRC / "edge_mlp.cu").read_text()
    found = {m[0]: int(m[1]) for m in re.findall(
        r"#define (EP_ROWS|EP_COLS|EP_BLOCKS|EP_LDW) (\d+)", src)}
    assert found == {"EP_ROWS": E._PROJ_ROWS, "EP_COLS": E._PROJ_COLS,
                     "EP_BLOCKS": E._PROJ_BLOCKS, "EP_LDW": E._PROJ_LDW}
    assert "EP_BLOCKS * (p.p_smem + 1024) > 233472" in src
    assert "4 * p.kc * EP_LDW" in src


# (later widths from H_0, blocks an SM): the flagship's admitted steps
CHAIN_SHAPES = [((64, 64, 64), 3), ((128, 128), 2), ((256, 256), 1),
                ((7,), 3), ((512, 512), 1)]


@pytest.mark.parametrize("chain,per_sm", CHAIN_SHAPES)
def test_chain_launch_shape(chain, per_sm):
    """Narrow chains run 64-row chunks at 3 (<= 64 wide) or 2 (<= 128)
    blocks an SM, their buffers within the SM's 228 KB; the queries a
    block fill whole waves of those blocks."""
    for queries in (5760, 11520, 23040):
        rows, tq, kc, got = E._chain_shape(chain, 21, queries, 132)
        assert got == per_sm
        smem = G._smem_bytes(rows, tq, kc, 21, chain, chain[-1], False)
        assert per_sm * (smem + _build.BLOCK_RESERVED) <= _build.SM_SMEM
        if per_sm > 1:
            assert rows == 64 and max(chain[1:], default=8) <= 64 * (4 - per_sm)
        blocks = -(-queries // tq)
        assert blocks / (132 * per_sm * -(-blocks // (132 * per_sm))) > 0.95


def k5_model(table, counts, nbr, query, q_valid, k, r2):
    """K5's warp scan order, all queries at once: per stencil column, the
    row's live records 32 at a time, each chunk's survivors of the r2 test
    and the strict k-th reject merged into the list on (d2, position =
    column x cap + slot)."""
    q, s = nbr.shape
    cap = table.shape[1]
    inf = torch.tensor(float("inf"))
    ld = torch.full((q, k), float("inf"))
    lp = torch.full((q, k), -1, dtype=torch.int64)
    rows = nbr.long()
    for col in range(s):
        live = counts[rows[:, col]].long()
        for j0 in range(0, int(live.max()), 32):
            j = torch.arange(j0, j0 + 32)
            rec = table[rows[:, col, None], j.clamp(max=cap - 1)]  # (Q, 32, 4)
            dx, dy, dz = (query[:, None, a] - rec[..., a] for a in range(3))
            d2 = (dx * dx + dy * dy) + dz * dz
            pos = col * cap + j[None].expand(q, -1)
            pid = rec[..., 3].contiguous().view(torch.int32)
            acc = ((j[None] < live[:, None]) & (pid >= 0) & (d2 <= r2) &
                   q_valid[:, None] & (d2 < ld[:, k - 1:]))  # strict reject
            cd = torch.cat([ld, torch.where(acc, d2, inf)], 1)
            cp = torch.cat([lp, torch.where(acc, pos, -1)], 1)
            order = torch.argsort(cp, dim=1, stable=True)     # then by d2
            cd, cp = cd.gather(1, order), cp.gather(1, order)
            order = torch.argsort(cd, dim=1, stable=True)[:, :k]
            ld, lp = cd.gather(1, order), cp.gather(1, order)
    found = lp >= 0
    col, slot = lp.clamp(min=0) // cap, lp.clamp(min=0) % cap
    rec = table[rows.gather(1, col), slot]
    pid = rec[..., 3].contiguous().view(torch.int32)
    return (torch.where(found, ld, torch.full_like(ld, grid_topk.INF)),
            torch.where(found, pid, torch.full_like(pid, -1)))


def _tie_table(seed):
    """A hand-made record table: lattice points (many equal distances),
    rows of more than 32 records, an empty row (the last), stencils of 29
    columns with repeated rows; query 0 at the origin reads a row whose
    nearest records lie exactly at r2 = 0.0625 (and one twice), query 1
    sits on a point placed in two rows."""
    rng = np.random.default_rng(seed)
    n_rows, cap, s = 12, 48, 29
    lattice = np.stack(np.meshgrid(*[np.arange(-3, 4)] * 3, indexing="ij"),
                       -1).reshape(-1, 3).astype(np.float32) * 0.125
    table = np.zeros((n_rows, cap, 4), np.float32)
    table[..., 3] = np.array(-1, np.int32).view(np.float32)
    counts = np.zeros(n_rows, np.int32)
    pid = 0
    for r in range(n_rows - 1):
        live = int(rng.integers(0, cap + 1)) if r else cap
        pts = lattice[rng.integers(0, len(lattice), live)]
        table[r, :live, :3] = pts
        table[r, :live, 3] = np.arange(pid, pid + live,
                                       dtype=np.int32).view(np.float32)
        counts[r], pid = live, pid + live
    at_r2 = np.array([[0.25, 0, 0], [0, 0.375, 0], [0, 0, -0.25],
                      [0, 0, -0.25]], np.float32)
    table[10, :, :3] = 0.0
    table[10, :, 3] = np.array(-1, np.int32).view(np.float32)
    table[10, :4, :3] = at_r2
    table[10, :4, 3] = np.arange(pid, pid + 4, dtype=np.int32).view(np.float32)
    counts[10] = 4
    table[1, 0] = table[0, 3]                         # one point, two rows
    counts[1] = max(counts[1], 1)
    q = 40
    query = lattice[rng.integers(0, len(lattice), q)].copy()
    nbr = rng.integers(0, n_rows, (q, s)).astype(np.int32)
    nbr[:, :2] = [0, 1]
    q_valid = rng.random(q) > 0.1
    query[0], nbr[0], q_valid[0] = 0.0, n_rows - 1, True
    nbr[0, 3] = 10
    query[1], q_valid[1] = table[0, 3, :3], True
    return (torch.from_numpy(table), torch.from_numpy(counts),
            torch.from_numpy(nbr), torch.from_numpy(query),
            torch.from_numpy(q_valid))


@pytest.mark.parametrize("k", [32, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_k5_model_matches_plain_on_ties(k, seed):
    table, counts, nbr, query, q_valid = _tie_table(seed)
    r2 = float(np.float32(0.0625))
    got = k5_model(table, counts, nbr, query, q_valid, k, r2)
    want = grid_topk.grid_topk_records_ref(table, counts, nbr, query,
                                           q_valid, k, r2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # query 0: the three records at r2 exactly, the tied pair in order
    assert want[0][0, :3].tolist() == [0.0625] * 3
    assert want[1][0, 1] + 1 == want[1][0, 2]
    # query 1: its point from both rows (and again from repeated rows)
    twice = int(table[0, 3, 3].view(torch.int32))
    assert int((want[1][1] == twice).sum()) >= 2
    d2 = want[0]
    assert bool(((d2[:, 1:] == d2[:, :-1]) & (d2[:, 1:] < 1e30)).any())


@pytest.mark.parametrize("cap,stencil,planes", [(8, 27, 2), (40, 27, 0)])
def test_k5_model_matches_plain_on_grid_tables(cap, stencil, planes):
    rng = np.random.default_rng(cap)
    pts = (rng.integers(-6, 7, (1, 900, 3)) * 0.05).astype(np.float32)
    valid = torch.from_numpy(rng.random((1, 900)) > 0.05)
    pts = torch.from_numpy(pts)
    radius, bits = 0.1, 6
    table, counts, _, _, _ = grid_knn.build_table(pts, valid, radius, cap,
                                                  bits, planes)
    nbr = grid_knn.stencil_rows(pts, radius, radius, stencil, bits, planes)[0]
    args = (table, counts, nbr.int(), pts[0], valid[0], 32,
            float(np.float32(radius * radius)))
    got = k5_model(*args)
    want = grid_topk.grid_topk_records_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def k10_model(d, idx, k):
    """K10's arithmetic -> (values (Q, k), idx (Q, k))."""
    q, w = d.shape
    span = 128 if w % 4 == 0 else 32
    inf = torch.tensor(float("inf"))
    ld = torch.full((q, k), float("inf"))
    lc = torch.full((q, k), -1, dtype=torch.long)
    for c0 in range(0, w, span):
        v = d[:, c0:c0 + span]
        col = torch.arange(c0, c0 + v.shape[1]).expand(q, -1)
        # strict reject against the k-th value before the read; fills out
        acc = (v < ld[:, k - 1:]) & (v < grid_topk.INF * 0.98)
        cd = torch.cat([ld, torch.where(acc, v, inf)], 1)
        cc = torch.cat([lc, torch.where(acc, col, -1)], 1)
        order = torch.argsort(cc, dim=1, stable=True)     # then by value
        cd, cc = cd.gather(1, order), cc.gather(1, order)
        order = torch.argsort(cd, dim=1, stable=True)[:, :k]
        ld, lc = cd.gather(1, order), cc.gather(1, order)
    found = lc >= 0
    got_i = idx.gather(1, lc.clamp(min=0))
    return (torch.where(found, ld, torch.full_like(ld, grid_topk.INF)),
            torch.where(found, got_i, torch.full_like(got_i, -1)))


def _k10_rows(w, seed, awkward=False):
    """(d, idx) of 48 rows: multiples of 1/8 below 4 (many ties, values
    the Pallas kernel's quantization keeps), 60% 1e30 fills, rows of fills
    only, a row of one repeated value, a row whose k-th value repeats
    across reads; with ``awkward`` also values at and above the fill limit
    (0.97e30, 0.98e30, 0.99e30, inf) and negative ones."""
    rng = np.random.default_rng(seed)
    q = 48
    d = (rng.integers(0, 32, (q, w)) / 8).astype(np.float32)
    d[rng.random((q, w)) < 0.6] = 1e30
    d[:3] = 1e30                                      # rows with nothing
    d[3] = 0.5                                        # one value throughout
    d[4] = 1e30
    d[4, ::7] = 0.25                                  # ties past every read
    if awkward:
        spots = rng.random((q, w))
        d[spots < 0.05] = np.float32(0.98e30)
        d[(spots >= 0.05) & (spots < 0.08)] = np.float32(0.97e30)
        d[(spots >= 0.08) & (spots < 0.1)] = np.inf
        d[(spots >= 0.1) & (spots < 0.12)] = np.float32(0.99e30)
        d[5] = -d[5].clip(max=4.0)
    idx = rng.integers(0, 10000, (q, w)).astype(np.int32)
    return torch.from_numpy(d), torch.from_numpy(idx)


@pytest.mark.parametrize("w", [928, 301])
@pytest.mark.parametrize("k", [1, 8, 16, 32])
def test_k10_model_matches_plain_and_pallas(k, w):
    d, idx = _k10_rows(w, seed=k + w)
    got = k10_model(d, idx, k)
    want = grid_topk.topk_smallest_ref(d, idx, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jd, ji = pallas_topk.topk_smallest(jnp.asarray(d.numpy()),
                                       jnp.asarray(idx.numpy()), k,
                                       interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
    assert bool((want[1][:3] == -1).all())            # rows of fills
    assert want[1][3].tolist() == idx[3, :k].tolist()  # lower columns first


@pytest.mark.parametrize("w", [1856, 30, 5])
@pytest.mark.parametrize("k", [1, 32])
def test_k10_model_matches_plain_at_the_fill_limit(k, w):
    """Values at and above the fill limit, inf and negatives; rows
    narrower than a read and than k (``topk_smallest`` takes k <= W, the
    model any k)."""
    d, idx = _k10_rows(w, seed=3 * k + w, awkward=True)
    k = min(k, w)
    got = k10_model(d, idx, k)
    want = grid_topk.topk_smallest_ref(d, idx, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool((want[0] >= np.float32(0.98e30)).logical_and(
        want[1] >= 0).any())


def _c_signatures():
    """{name: [ctypes type a parameter]} of every ``extern "C"`` entry of
    ``csrc/*.cu``: pointers as c_void_p, int / float / long long as
    themselves."""
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (ccn_\w+)\(([^)]*)\)', text):
            types = []
            for param in m.group(2).split(","):
                decl = " ".join(param.split()[:-1]).replace("const ", "")
                types.append(ctypes.c_void_p if "*" in param
                             else kinds[decl.strip()])
            found[m.group(1)] = types
    return found


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signature_matches_the_source(name):
    """Each entry the wrappers call is declared to ctypes with the C
    parameter list of its source (K9's changed: the layers' pointers, the
    image, the plan, and its projection's own entry; K8-bf16's forward:
    the image and the plan)."""
    assert _c_signatures()[name] == _build._SIGNATURES[name]
