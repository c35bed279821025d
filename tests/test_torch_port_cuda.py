"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a GPU.  On a
machine with one (and nvcc), run::

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerances: K1 and K2 multiply in 3xTF32 on the tensor cores (f32
accuracy; K1 projects the input on the stacked taps and shifts the
products), 1e-4 relative to the output scale; K3 distances and K6 picks use
round-to-nearest arithmetic in the plain versions' order, so they match
exactly (indices may differ only between slots of equal distance; at
k > 32, the version-1.0 ball queries, indices and distances are held
bit-equal, ties included, as the list orders (d2, index)).  K7:
forward outputs and batch statistics 1e-4 relative to their scale;
gradients in relative L2 norm within 1e-3 plus 3x the plain version's own
change when h1 is perturbed by 1e-5 relative (norms floored at 1e-3 of
the call's largest, for tensors that are zero in exact arithmetic): the
activation's derivative jumps at 0 (1 vs 0.01) and a max picks one of two
near-equal slots, so rare rows within rounding of such a point take
another branch in the kernel than in the plain version, moving single
elements by up to their own size; K7 sums across blocks in a fixed order,
so two runs agree bit for bit.  K8 (3xTF32 window products): forward z 1e-4, its
statistics 1e-5, the reduce and t passes K7's yardstick with z perturbed,
the whole chain's value 1e-4 and gradients 1e-3 in relative L2 norm
against torch autograd of the plain chain (at the sweep's size plus 3x the
plain chain's change under a 1e-5 perturbation of xe: one of ~10^7 BN
outputs within rounding of leaky's kink moves every gradient by ~1e-3);
its t pass sums dW and db in a fixed order, so two runs agree bit for
bit.  The K1 and K8 cases put the live count inside the row, at 0 and a
block's tile edge, inside a halo and at n_exp, and one at the nuScenes
sweep's size.  K9 projects layer 0 once a point (x_j (Wt - Wb) + x_i Wb,
rounded otherwise than [x_j, x_i - x_j] W_0) and multiplies in 3xTF32:
1e-4 relative to the largest value other than the -100 fill, -100 exactly
at queries with no live slot, a repeat run bit-equal.
K11 (the mesh rasterizer) rounds every operation once in the C++
z-buffer's order and takes its winner of a pixel: coords, normals and mask
bit-equal to the plain version.
K4 copies rows (exact);
K4b adds with atomics (1e-5).  K5 and K10 compute squared distances in the
plain versions' order and break ties alike (the earlier column): equal,
also on tie-heavy tables (K10 also on unaligned and W % 4 != 0 rows), and
bit-equal from run to run.  K8's t pass, where it takes the previous
layer's reduce sums, holds them against the plain reduce on its own
d_u_prev at 1e-3 of max(1, |plain|), bit-equal from run to run.  The whole
train step is held to the CPU
plain path against a yardstick: the plain path's own change under a 1e-5
relative weight perturbation (train-mode BatchNorm over 33 steps amplifies
rounding-sized differences).
"""

import numpy as np
import pytest
import torch

from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.ops import (conv1d_chain, conv1d_train,
                                         edge_mlp, fps, gather, grid_knn,
                                         grid_topk, group_reduce,
                                         group_train, knn)
from curvecloudnet_tpu_torch.simulator import generate as sim_generate
from curvecloudnet_tpu_torch.simulator import rasterizer
from curvecloudnet_tpu_torch.train.__main__ import synthetic_batch
from curvecloudnet_tpu_torch.train.trainer import (LossConfig,
                                                   create_optimizer,
                                                   train_step)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _conv_used(case, n_exp, tile):
    """The two samples' live counts: inside the row ("mid"), 0 and a
    block's tile edge, or a slot inside the first block's halo and
    n_exp."""
    return torch.tensor({"mid": [2900, 1700], "edges": [0, tile],
                         "halo_end": [tile + 1, n_exp]}[case],
                        dtype=torch.int32)


# the main path's C0 8 / 262 (h 2, three layers of 32) and a ragged width;
# the live count inside the row, at 0 and a tile edge, inside a halo and at
# n_exp; one case at the nuScenes sweep's size
CHAIN_CASES = [(c0, dims, h, 3000, case)
               for c0, dims, h in [(8, (32, 32, 32), 2),
                                   (262, (32, 32, 32), 2), (5, (16, 24), 1)]
               for case in ("mid", "edges", "halo_end")] + [
    (262, (32, 32, 32), 2, 49164, "halo_end")]


@pytest.mark.parametrize("c0,dims,h,n_exp,case", CHAIN_CASES)
def test_conv1d_chain_kernel(dev, c0, dims, h, n_exp, case):
    g = torch.Generator().manual_seed(0)
    xe = torch.randn(2, n_exp, c0, generator=g)
    weights, cin = [], c0
    for cout in dims:
        weights.append((0.1 * torch.randn((h + 1) * cin, cout, generator=g),
                        0.1 * torch.randn(cout, generator=g)))
        cin = cout
    used = _conv_used(case, n_exp, conv1d_chain.tile_rows(h, len(dims)))
    args = (xe.to(dev), tuple((w.to(dev), b.to(dev)) for w, b in weights),
            used.to(dev), h)
    got = conv1d_chain.conv1d_chain_eval(*args)
    assert _rel_err(got, conv1d_chain.conv1d_chain_eval_ref(*args)) <= 1e-4


# aggr, K, message widths (h1's first), attention widths, live fraction of
# the slots, queries: the main path's sites (sa-geo's 3-4 live slots of 25,
# KITTI's K = 31, the 512-wide attend and 1024-wide max sites), a ragged
# width, the single-layer MLP (h1 is the message); M is no multiple of any
# query tile, and 5% of the queries have no live slot, half of them with K
# equal planes
GROUP_CASES = [
    ("max", 21, (64, 64, 64), None, 0.6, 3001),
    ("attend", 25, (64, 128, 192, 256), (256, 256, 256), 0.15, 2999),
    ("attend", 31, (64, 128, 192, 256), (256, 256, 256), 0.1, 1501),
    ("attend", 32, (128, 128, 128), (128, 64, 128), 0.5, 1203),
    ("attend", 32, (512, 512, 512), (512, 256, 512), 0.8, 301),
    ("max", 32, (1024, 1024, 1024), None, 0.85, 203),
    ("max", 21, (1024, 1024), None, 0.85, 203),
    ("max", 21, (36, 20, 44), None, 0.7, 517),
    ("max", 21, (128,), None, 0.7, 517),
    ("attend", 25, (128,), (128, 64, 128), 0.3, 517),
    # the A2D2 ball-grouped sa steps: K = 128 planes, 15-50% live
    ("attend", 128, (128, 128, 128), (128, 128, 128), 0.3, 2017),
    ("attend", 128, (256, 256, 256), (256, 256, 256), 0.2, 505),
    ("attend", 128, (512, 512, 512), (512, 512, 512), 0.15, 127),
    # the object configs' last sa row: K = 64 (the ball capped at the row)
    ("attend", 64, (512, 512, 512), (512, 512, 512), 0.5, 33),
]


@pytest.mark.parametrize("aggr,k,widths,att,live,m", GROUP_CASES)
def test_group_reduce_kernel(dev, aggr, k, widths, att, live, m):
    g = torch.Generator().manual_seed(1)
    c1 = widths[0]
    h1 = torch.randn(1, k, m, c1, generator=g)
    mask = torch.rand(1, m, k, generator=g) < live
    mask[:, torch.rand(m, generator=g) < 0.05] = False
    # every other query with no live slot has K equal planes (padding)
    padded = torch.nonzero(~mask[0].any(-1))[::2, 0]
    h1[0, :, padded] = h1[0, :1, padded]
    layers = lambda ws: tuple(  # noqa: E731
        (torch.randn(a, b, generator=g) / a ** 0.5,
         0.1 * torch.randn(b, generator=g)) for a, b in zip(ws[:-1], ws[1:]))
    if len(widths) == 1:     # one-layer MLP: identity affine and act
        aff, act = (torch.ones(c1), torch.zeros(c1)), "identity"
    else:
        aff = (0.5 + torch.rand(c1, generator=g),
               0.1 * torch.randn(c1, generator=g))
        act = "leaky_relu"
    move = lambda ls: None if ls is None else tuple(  # noqa: E731
        (w.to(dev), b.to(dev)) for w, b in ls)
    args = (h1.to(dev), mask.to(dev), tuple(t.to(dev) for t in aff),
            move(layers(widths)), move(None if att is None else layers(att)))
    kw = dict(aggr=aggr, act=act)
    got = group_reduce.group_reduce(*args, **kw)
    want = group_reduce.group_reduce_ref(*args, **kw)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 1e-4
    dead = ~mask.any(-1).to(dev)
    assert bool(dead.any())
    if aggr == "max":
        assert bool((got[dead] == -100.0).all())


@pytest.mark.parametrize("k,radius", [(32, 0.3), (3, None), (20, None)])
def test_knn_kernel(dev, k, radius):
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 700, 3, generator=g)
    p = torch.randn(2, 1500, 3, generator=g)
    qv = torch.rand(2, 700, generator=g) > 0.1
    pv = torch.rand(2, 1500, generator=g) > 0.1
    args = tuple(t.to(dev) for t in (q, p, qv, pv))
    i_k, d_k = knn.knn_search(*args, k, radius)
    i_r, d_r = knn.knn_search_ref(*args, k, radius)
    assert torch.equal(d_k, d_r)
    assert not bool(((i_k != i_r) & (d_k != d_r)).any())


def test_fps_kernel(dev):
    g = torch.Generator().manual_seed(3)
    pos = torch.randn(2, 2000, 3, generator=g)
    valid = torch.ones(2, 2000, dtype=torch.bool)
    valid[1, 1500:] = False
    start = torch.tensor([0, 7], dtype=torch.int32)
    args = tuple(t.to(dev) for t in (pos, valid, start))
    assert torch.equal(fps.fps_picks(*args, 400), fps.fps_picks_ref(*args, 400))


def test_fps_kernel_at_kitti_row(dev):
    """The KITTI fps row: 18432 points, 17000 of them valid (past the 32
    points a thread whose positions sit in registers: the rest read from
    shared memory), 5530 picks."""
    g = torch.Generator().manual_seed(7)
    pos = torch.randn(1, 18432, 3, generator=g)
    valid = torch.ones(1, 18432, dtype=torch.bool)
    valid[0, 17000:] = False
    start = torch.tensor([0], dtype=torch.int32)
    args = tuple(t.to(dev) for t in (pos, valid, start))
    assert torch.equal(fps.fps_picks(*args, 5530),
                       fps.fps_picks_ref(*args, 5530))


def _sweep_row(seed, n, n_beams, n_valid=None, dup=0):
    """A lidar-like row of ``n`` slots in scan order (the port's synthetic
    sweep): its first ``n_valid`` slots valid, the rest junk; ``dup``
    consecutive points of its second half copied near its start (exact
    ties in a tile of lower index than the original's)."""
    from curvecloudnet_tpu_torch.data.synthetic import lidar_sweep

    rng = np.random.default_rng(seed)
    n_valid = n if n_valid is None else n_valid
    pos = lidar_sweep(rng, 2 * n_valid, n_beams)[0]
    pos = pos[np.sort(rng.permutation(len(pos))[:n_valid - dup])]
    if dup:
        at = int(rng.integers(len(pos) // 2, len(pos) - dup))
        pos = np.insert(pos, len(pos) // 20, pos[at:at + dup], axis=0)
    full = rng.normal(size=(n, 3)).astype(np.float32)
    full[:len(pos)] = pos
    valid = np.zeros(n, bool)
    valid[:len(pos)] = True
    return torch.from_numpy(full), torch.from_numpy(valid)


def _assert_knn_equal(args, k, radius):
    i_k, d_k = knn.knn_search(*args, k, radius)
    i_r, d_r = knn.knn_search_ref(*args, k, radius)
    assert torch.equal(d_k, d_r)
    assert not bool(((i_k != i_r) & (d_k != d_r)).any())


# (rows of (n, n_beams, valid points), subset queries: every other point,
# k, radius, duplicated points): the flagship's 23040-point table and the
# KITTI 5530-point row (a quarter valid), an fp-style query set (Q != N),
# B = 2 with different valid counts, duplicates, a ragged last tile, a
# radius that admits only the query itself, k above the valid count
KNN_ROWS = [
    (((23040, 32, None),), False, 32, 0.04, 0),
    (((5530, 64, 1242),), False, 32, 0.5, 0),
    (((11520, 32, 9420),), True, 3, None, 0),
    (((5760, 32, 3019), (5760, 32, 2500)), False, 32, 0.3, 0),
    (((4001, 32, 3000),), False, 32, 0.1, 200),
    (((1037, 16, 1037), (1037, 16, 900)), True, 8, 1e-6, 0),
    (((1037, 16, 20),), False, 32, None, 0),
]


@pytest.mark.parametrize("rows,subset,k,radius,dup", KNN_ROWS)
def test_knn_kernel_at_sweep_rows(dev, rows, subset, k, radius, dup):
    made = [_sweep_row(i, n, beams, nv, dup)
            for i, (n, beams, nv) in enumerate(rows)]
    p = torch.stack([m[0] for m in made])
    pv = torch.stack([m[1] for m in made])
    q, qv = (p[:, 1::2].contiguous(), pv[:, 1::2].contiguous()) if subset \
        else (p, pv)
    if subset:
        p, pv = p[:, ::2].contiguous(), pv[:, ::2].contiguous()
    args = tuple(t.to(dev) for t in (q, p, qv, pv))
    _assert_knn_equal(args, min(k, p.shape[1]), radius)
    seen, total = knn.tile_visits(*args, min(k, p.shape[1]), radius)
    assert 0 < seen <= total


def _split_row(seed, n_q, n_p, shuffled, dup=0):
    """A synthetic sweep of n_q + n_p points split into a query set and a
    row, each in the sweep's order or shuffled; ``dup`` points of the row
    copied onto others (exact ties)."""
    from curvecloudnet_tpu_torch.data.synthetic import lidar_sweep

    rng = np.random.default_rng(seed)
    pts = lidar_sweep(rng, 2 * (n_q + n_p), 32)[0]
    pts = pts[np.sort(rng.permutation(len(pts))[:n_q + n_p])]
    if shuffled:
        pts = pts[rng.permutation(len(pts))]
    pick = np.zeros(len(pts), bool)
    pick[rng.permutation(len(pts))[:n_p]] = True
    q, p = pts[~pick], pts[pick].copy()
    if dup:
        p[rng.permutation(n_p)[:dup]] = p[rng.permutation(n_p)[:dup]]
    return torch.from_numpy(q), torch.from_numpy(p)


# calls that launch K3's brute-force route (k <= 8, at least
# knn.BRUTE_MIN_Q queries): rows without scan-order locality take it (randn,
# a shuffled sweep with duplicates and a radius), and B = 2 with a row in
# scan order (the tiled search) beside a shuffled one
@pytest.mark.parametrize("kind,k,radius,dup", [
    ("randn", 3, None, 0), ("shuffled", 8, 0.3, 300), ("mixed", 5, None, 0)])
def test_knn_kernel_brute_route(dev, kind, k, radius, dup):
    n_q, n_p = knn.BRUTE_MIN_Q + 600, 12000
    g = torch.Generator().manual_seed(4)
    if kind == "randn":
        qs, ps = torch.randn(1, n_q, 3, generator=g), torch.randn(
            1, n_p, 3, generator=g)
    else:
        made = [_split_row(30 + i, n_q, n_p, kind == "shuffled" or i == 1,
                           dup) for i in range(1 if kind == "shuffled" else 2)]
        qs = torch.stack([m[0] for m in made])
        ps = torch.stack([m[1] for m in made])
    qv = torch.rand(qs.shape[:2], generator=g) > 0.05
    pv = torch.rand(ps.shape[:2], generator=g) > 0.1
    args = tuple(t.to(dev) for t in (qs, ps, qv, pv))
    _assert_knn_equal(args, k, radius)
    seen, total = knn.tile_visits(*args, k, radius)
    if kind == "mixed":
        assert 0.45 * total < seen < total
    else:
        assert seen == total


def _tie_row(seed, n):
    """Points on a 0.01 lattice, a fifth of them repeated: exact distance
    ties everywhere, across the list's registers at k > 32."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 12, size=(n, 3)).astype(np.float32) * 0.01
    pts[rng.permutation(n)[:n // 5]] = pts[rng.permutation(n)[:n // 5]]
    return torch.from_numpy(pts), torch.from_numpy(rng.random(n) > 0.05)


@pytest.mark.parametrize("k", [33, 64, 100, 128])
@pytest.mark.parametrize("radius", [None, 0.05])
@pytest.mark.parametrize("kind", ["scan", "shuffled", "ties"])
def test_knn_kernel_above_32(dev, k, radius, kind):
    """K3 at k > 32 (ball queries, k = 128 in the version-1.0 sa steps):
    FPS-style query sets (every third point) against a scan-order A2D2-like
    row (80 beams), the same row shuffled, and a lattice of ties; with a
    radius most balls hold fewer than k points (-1 / 1e30 past them).
    Indices and distances bit-equal to the plain version's."""
    if kind == "ties":
        p, pv = _tie_row(k, 6000)
    else:
        p, pv = _sweep_row(k, 8064, 80, 7500)
        if kind == "shuffled":
            perm = torch.from_numpy(np.random.default_rng(1).permutation(
                p.shape[0]))
            p, pv = p[perm], pv[perm]
    q, qv = p[::3].contiguous(), pv[::3].contiguous()
    # on the lattice, a ball of 19 sites (~66 points)
    r = radius if kind != "ties" or radius is None else 0.015
    args = tuple(t[None].to(dev) for t in (q, p, qv, pv))
    i_k, d_k = knn.knn_search(*args, k, r)
    i_r, d_r = knn.knn_search_ref(*args, k, r)
    assert torch.equal(d_k, d_r) and torch.equal(i_k, i_r)
    if r is not None and kind != "ties":
        filled = (i_r >= 0).sum(-1)[qv[None].to(dev)]
        assert int(filled.min()) < k
    assert torch.equal(knn.knn_search(*args, k, r)[0], i_k)


def test_knn_kernel_k_up_to_32_unchanged(dev):
    """k <= 32 keeps the one-register list: the flagship's k = 32 table of
    a 23040-point row and k = 16 with a radius, bit-equal to plain."""
    p, pv = _sweep_row(5, 23040, 32)
    args = tuple(t[None].to(dev) for t in (p, p, pv, pv))
    for k, r in ((32, 0.04), (16, None)):
        i_k, d_k = knn.knn_search(*args, k, r)
        i_r, d_r = knn.knn_search_ref(*args, k, r)
        assert torch.equal(d_k, d_r) and torch.equal(i_k, i_r)


def test_knn_kernel_all_queries_invalid(dev):
    p, pv = _sweep_row(3, 2000, 32)
    args = tuple(t.to(dev) for t in (p[None], p[None],
                                     torch.zeros(1, 2000, dtype=torch.bool),
                                     pv[None]))
    i_k, d_k = knn.knn_search(*args, 16, 0.2)
    assert bool((i_k == -1).all()) and bool((d_k == 1e30).all())
    _assert_knn_equal(args, 16, 0.2)
    assert knn.tile_visits(*args, 16, 0.2) == (0, 0)


# (row size, valid counts, budget, duplicated points): ties across warps,
# B = 2 with different valid counts, budget equal to and above the valid
# count, the nuScenes 5760-point row, the largest row whose points all sit
# in shared memory, A2D2's 23040-point row (the 96-point build: points past
# a thread's first 24 in shared memory) and the largest row the wrapper
# takes, with ties and a row with fewer valid points than its registers hold
FPS_ROWS = [
    (5760, (3019,), 1728, 0),
    (5760, (3019, 2700), 1728, 300),
    (2000, (1500,), 1500, 0),
    (1728, (906, 700), 1000, 50),
    (fps.SMEM_N, (19000,), 600, 0),
    (23040, (21800,), 8064, 0),
    (fps.MAX_N, (24000, 5000), 3000, 300),
]


@pytest.mark.parametrize("n,valids,budget,dup", FPS_ROWS)
def test_fps_kernel_at_sweep_rows(dev, n, valids, budget, dup):
    made = [_sweep_row(10 + i, n, 32, nv, dup) for i, nv in enumerate(valids)]
    pos = torch.stack([m[0] for m in made])
    valid = torch.stack([m[1] for m in made])
    start = torch.tensor([5 * i for i in range(len(valids))],
                         dtype=torch.int32)
    args = tuple(t.to(dev) for t in (pos, valid, start))
    assert torch.equal(fps.fps_picks(*args, budget),
                       fps.fps_picks_ref(*args, budget))


@pytest.mark.parametrize("n,config", [(700, (32, 24)), (2400, (32, 76)),
                                      (700, (96, 8))])
def test_fps_kernel_narrow_ctas(dev, n, config):
    """Launch shapes the wrapper does not take (``tools/fps_sweep.py``
    does): one warp, whose slot pair's second slot no warp writes, without
    and with points read from shared memory (more than 32 a thread);
    three warps."""
    made = [_sweep_row(20 + i, n, 32, nv, 40)
            for i, nv in enumerate((n - 50, n * 2 // 3))]
    pos = torch.stack([m[0] for m in made])
    valid = torch.stack([m[1] for m in made])
    start = torch.tensor([3, 0], dtype=torch.int32)
    args = tuple(t.to(dev) for t in (pos, valid, start))
    for budget in (300, n):
        assert torch.equal(fps.fps_picks_config(*args, budget, config),
                           fps.fps_picks_ref(*args, budget))


def test_small_scan_matches_cpu_path(dev):
    """The flagship at n_pad 2048: GPU kernels vs the CPU plain path."""
    scan = predict.synthetic_scan(0, 2048, torch.device("cpu"))
    cpu = predict.predict(predict.build_model("configs/nuscenes.yaml", 2048,
                                              "cpu"), *scan)[0]
    gpu = predict.predict(predict.build_model("configs/nuscenes.yaml", 2048,
                                              dev), *(t.to(dev) for t in scan))[0]
    valid = scan[3]
    assert np.abs((gpu.cpu() - cpu)[valid].numpy()).max() <= 2e-3


def _k7_case(aggr, k, m, dims, a, live, b=2, seed=4):
    """K7 inputs: live=None keeps the first cases' masks (60% live slots,
    every fourth plane dead); otherwise a live fraction of the slots, 5%
    of the queries with no live slot."""
    g = torch.Generator().manual_seed(seed)
    h1 = torch.randn(b, k, m, dims[0], generator=g)
    if live is None:
        mask = torch.rand(b, m, k, generator=g) > 0.4
        mask[0, 7] = False
        mask[:, :, ::4] = False
    else:
        mask = torch.rand(b, m, k, generator=g) < live
        mask[torch.rand(b, m, generator=g) < 0.05] = False
    params = []
    for ci, co in zip(dims[:-1], dims[1:]):
        params += [0.5 + torch.rand(ci, generator=g),
                   0.1 * torch.randn(ci, generator=g),
                   torch.randn(ci, co, generator=g) / ci ** 0.5,
                   0.1 * torch.randn(co, generator=g)]
    if a:
        co = dims[-1]
        params += [torch.randn(co, a, generator=g) / co ** 0.5,
                   0.1 * torch.randn(a, generator=g),
                   0.5 + torch.rand(a, generator=g),
                   0.1 * torch.randn(a, generator=g),
                   torch.randn(a, co, generator=g) / a ** 0.5,
                   0.1 * torch.randn(co, generator=g)]
    cfg = group_train.TrainCfg(dims=dims, att_dim=a, aggr=aggr,
                               act="leaky_relu")
    return g, cfg, h1, mask, params


# aggr, K, M, widths, attention width, live fraction (None: the first
# cases' masks), batch: the main path's sites -- sa-geo's ~3.6 live slots
# of 25 at M 23040, the 512-wide attend site, the 1024-wide max sites, a
# KITTI-sa-geo-like site (M 73728, K 31) whose stored values must fit --
# with row counts that are no multiple of the 64-row tile
K7_CASES = [
    ("attend", 25, 300, (64, 128, 192, 256), 256, None, 2),
    ("attend", 32, 200, (512, 512, 512), 256, None, 2),
    ("max", 21, 300, (64, 64, 64), 0, None, 2),
    ("max", 32, 100, (1024, 1024, 1024), 0, None, 2),
    ("max", 21, 150, (1024, 1024), 0, None, 2),
    ("attend", 25, 23040, (64, 128, 192, 256), 256, 0.144, 1),
    ("attend", 32, 1728, (512, 512, 512), 256, 0.5, 1),
    ("max", 32, 519, (1024, 1024, 1024), 0, 0.457, 1),
    ("max", 21, 519, (1024, 1024), 0, 0.46, 1),
    ("attend", 31, 73728, (64, 128, 192, 256), 256, 0.128, 1),
]


@pytest.mark.parametrize("aggr,k,m,dims,a,live,b", K7_CASES)
def test_group_train_kernels(dev, aggr, k, m, dims, a, live, b):
    g, cfg, h1, mask, params = _k7_case(aggr, k, m, dims, a, live, b)
    assert int(mask.sum()) % group_train.TILE or live is None
    args = (h1.to(dev), mask.to(dev), cfg, tuple(p.to(dev) for p in params))
    out, stats, n, extras = group_train.group_train_fwd(*args)
    r_out, r_stats, r_n, r_extras = group_train.group_train_fwd_ref(*args)
    rows = mask.to(dev).any(-1)
    assert _rel_err(out[rows], r_out[rows]) <= 1e-4
    if aggr == "max":
        assert bool((out[~rows] == -100.0).all())
    for (mu, var), (r_mu, r_var) in zip(stats, r_stats):
        assert _rel_err(mu, r_mu) <= 1e-4 and _rel_err(var, r_var) <= 1e-4
    dout = torch.randn(b, m, dims[-1], generator=g).to(dev) * rows[..., None]
    # each backward takes its own forward's residuals: a max aggregation's
    # ties are exact equalities of the stored (or recomputed) values
    d_h1, grads = group_train.group_train_bwd(*args, stats, n, extras, dout)
    del extras
    r_h1, r_grads = group_train.group_train_bwd_ref(*args, r_stats, r_n,
                                                    r_extras, dout)
    del r_extras
    h1_s = args[0] * (1 + 1e-5 * torch.randn(h1.shape, generator=g).to(dev))
    s_args = (h1_s,) + args[1:]
    s_h1, s_grads = group_train.group_train_bwd_ref(
        *s_args, *group_train.group_train_fwd_ref(*s_args)[1:], dout)
    floor = 1e-3 * max(float(t.norm()) for t in (r_h1,) + tuple(r_grads))
    for got, want, shaken in zip((d_h1,) + tuple(grads),
                                 (r_h1,) + tuple(r_grads),
                                 (s_h1,) + tuple(s_grads)):
        scale = max(float(want.norm()), floor)
        assert (float((got - want).norm())
                <= 1e-3 * scale + 3 * float((shaken - want).norm()))


@pytest.mark.parametrize("aggr,dims,a", [("attend", (64, 128, 192, 256), 256),
                                         ("max", (512, 512, 512), 0)])
def test_group_train_kernels_repeat_bitwise(dev, aggr, dims, a):
    """No atomics: two runs of the same forward and backward give equal
    outputs, statistics and gradients, bit for bit."""
    g, cfg, h1, mask, params = _k7_case(aggr, 25, 2000, dims, a, 0.3, 1)
    args = (h1.to(dev), mask.to(dev), cfg, tuple(p.to(dev) for p in params))
    dout = torch.randn(1, 2000, dims[-1], generator=g).to(dev)
    runs = []
    for _ in range(2):
        out, stats, n, extras = group_train.group_train_fwd(*args)
        d_h1, grads = group_train.group_train_bwd(*args, stats, n, extras,
                                                  dout)
        runs.append([out, *[t for mv in stats for t in mv], d_h1, *grads])
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.parametrize("c,fill", [(64, True), (1024, False), (35, True)])
def test_gather_kernels(dev, c, fill):
    g = torch.Generator().manual_seed(5)
    n, k = 3000, 21
    src = torch.randn(2, n, c, generator=g).to(dev)
    idx = torch.randint(-1, n, (2, k, n), generator=g,
                        dtype=torch.int32).to(dev)
    assert torch.equal(gather.gather_km(src, idx, fill),
                       gather.gather_km_ref(src, idx, fill))
    d = torch.randn(2, k, n, c, generator=g).to(dev)
    assert _rel_err(gather.scatter_km(d, idx, n, fill),
                    gather.scatter_km_ref(d, idx, n, fill)) <= 1e-5


def test_small_train_step_matches_cpu_path(dev):
    """One train step of the flagship at n_pad 2048: the GPU kernels
    against the CPU plain path, same weights and batch; each gradient
    within 2e-3 of its largest entry or within 3x the CPU path's change
    under a 1e-5 relative weight perturbation."""
    grads, losses = [], []
    for device, shake in (("cpu", False), ("cpu", True), (dev, False)):
        model = predict.build_model("configs/nuscenes.yaml", 2048, device)
        if shake:
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 1e-5 * torch.randn(p.shape, generator=g))
        opt = create_optimizer(model)
        batch = synthetic_batch(0, 2048, device)
        losses.append(float(train_step(model, opt, 0.0, batch, None, 0.1,
                                       LossConfig(use_lovasz=True))["loss"]))
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None})
    assert abs(losses[0] - losses[2]) <= 1e-4 * abs(losses[0])
    assert grads[0].keys() == grads[2].keys()
    # floor for gradients that are zero in exact arithmetic (rounding noise)
    floor = 1e-5 * max(float(g.abs().max()) for g in grads[0].values())
    for k, want in grads[0].items():
        err = float((grads[2][k] - want).abs().max())
        noise = float((grads[1][k] - want).abs().max())
        assert err <= 3 * noise + 2e-3 * float(want.abs().max()) + floor, k


@pytest.mark.parametrize("n,radius,cap,bits", [(73728, 0.04, 192, 14),
                                               (36864, 0.1, 64, 15)])
def test_grid_kernels_at_kitti_tables(dev, n, radius, cap, bits):
    """K5 and K10 at the two KITTI grid tables' shapes (a 64-beam sweep of
    the row's size, every point a query, k 32, two overflow rows)."""
    pos, _, _, valid = predict.synthetic_scan(0, n, dev, n_beams=64)
    table, counts, _, _, _ = grid_knn.build_table(pos, valid, radius, cap,
                                                  bits, 2)
    nbr = grid_knn.stencil_rows(pos, radius, radius, 27, bits, 2)[0]
    args = (table, counts, nbr.int().contiguous(), pos[0].contiguous(),
            valid[0].contiguous(), 32, float(np.float32(radius * radius)))
    got = grid_topk.grid_topk_records(*args)
    want = grid_topk.grid_topk_records_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = grid_topk.grid_topk_records(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    planes = grid_topk.planes(args[0], *args[2:5], args[6])
    k10 = grid_topk.topk_smallest(*planes, 32)
    k10_ref = grid_topk.topk_smallest_ref(*planes, 32)
    for a, b, c in zip(k10, k10_ref, got):
        assert torch.equal(a, b) and torch.equal(a, c)


def _k10_table(q, w, seed):
    """Tie-heavy rows (multiples of 1/8, 60% 1e30 fills, rows of fills
    only, a row of one repeated value, ties at every 7th column) and
    values at the fill limit."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randint(0, 32, (q, w), generator=g).float() / 8
    spots = torch.rand(q, w, generator=g)
    d[spots < 0.6] = 1e30
    d[(spots >= 0.6) & (spots < 0.62)] = 0.98e30
    d[(spots >= 0.62) & (spots < 0.64)] = 0.97e30
    d[:3] = 1e30
    d[3] = 0.5
    d[4] = 1e30
    d[4, ::7] = 0.25
    return d, torch.randint(0, 100000, (q, w), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("w,offset", [(928, 0), (928, 1), (301, 0)])
@pytest.mark.parametrize("k", [1, 8, 16, 32])
def test_topk_smallest_kernel_on_ties(dev, k, w, offset):
    """K10 on tie-heavy rows: float4 reads (W % 4 == 0, aligned), the
    scalar reads (d 4 bytes off a 16-byte boundary; W % 4 != 0): equal to
    the plain version, and a repeat run bit-equal."""
    d, idx = _k10_table(700, w, seed=k + w + offset)
    flat = torch.empty(700 * w + offset, device=dev)
    flat[offset:] = d.to(dev).reshape(-1)
    d_dev = flat[offset:].view(700, w)      # contiguous, maybe unaligned
    args = (d_dev, idx.to(dev), k)
    got = grid_topk.topk_smallest(*args)
    want = grid_topk.topk_smallest_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = grid_topk.topk_smallest(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("k", [32, 7])
def test_grid_topk_kernel_on_ties(dev, k):
    """K5 on a tie-heavy table: lattice points 0.125 apart (exact
    distances, many equal), coincident points, records at r2 = 0.0625
    exactly, a stencil row read twice (its points in two columns): equal
    to the plain version, and a repeat run bit-equal."""
    g = torch.Generator().manual_seed(4)
    pts = (torch.randint(-12, 13, (1, 6000, 3), generator=g) * 0.125).float()
    valid = torch.rand(1, 6000, generator=g) > 0.05
    radius, cap, bits = 0.25, 64, 10
    table, counts, _, _, _ = grid_knn.build_table(pts, valid, radius, cap,
                                                  bits, 2)
    nbr = grid_knn.stencil_rows(pts, radius, radius, 27, bits, 2)[0]
    nbr[:, 5] = nbr[:, 0]
    r2 = float(np.float32(radius * radius))
    args = (table.to(dev), counts.to(dev), nbr.int().contiguous().to(dev),
            pts[0].to(dev), valid[0].to(dev), k, r2)
    got = grid_topk.grid_topk_records(*args)
    want = grid_topk.grid_topk_records_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[0] == r2).any())
    assert bool(((want[0][:, 1:] == want[0][:, :-1])
                 & (want[1][:, 1:] >= 0)).any())
    again = grid_topk.grid_topk_records(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("cap,stencil,planes,k", [(8, 27, 2, 32),
                                                  (1, 8, 0, 12)])
def test_grid_search_spills_on_the_card(dev, cap, stencil, planes, k):
    """A dense cluster past the cap, k above most queries' live
    candidates (and, at cap 1 on the 8-cell stencil, above the candidate
    width): both tails on the card equal the CPU plain path."""
    g = torch.Generator().manual_seed(6)
    pts = torch.cat([0.05 + 0.005 * torch.randn(1, 300, 3, generator=g),
                     torch.rand(1, 1500, 3, generator=g) - 0.5], dim=1)
    valid = torch.rand(1, 1800, generator=g) > 0.1
    args = (pts[:, :700], pts, valid[:, :700], valid, k, 0.1)
    kw = dict(cap=cap, stencil=stencil, overflow_planes=planes)
    want = grid_knn.grid_knn(*args, **kw)
    for tail in grid_knn.TAILS:
        got = grid_knn.grid_knn(*(t.to(dev) if torch.is_tensor(t) else t
                                  for t in args), tail=tail, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def _yardstick_ok(got, want, shaken, tol=1e-3):
    """Relative L2 within ``tol`` plus 3x the plain version's own change
    under a 1e-5 input perturbation (norms floored at 1e-3 of the
    largest)."""
    floor = 1e-3 * max(float(w.norm()) for w in want)
    for g, w, s in zip(got, want, shaken):
        scale = max(float(w.norm()), floor)
        assert float((g - w).norm()) <= tol * scale + 3 * float((s - w).norm())


def _train_inputs(c0, dims, h, n_exp, case, seed=8):
    g = torch.Generator().manual_seed(seed)
    used = _conv_used(case, n_exp, conv1d_train.fwd_tile(h))
    xe = torch.randn(2, n_exp, c0, generator=g)
    for bi in range(2):
        xe[bi, int(used[bi]):] = 0
    params, cin = [], c0
    for cout in dims:
        params.append((torch.randn((h + 1) * cin, cout, generator=g)
                       / ((h + 1) * cin) ** 0.5,
                       0.1 * torch.randn(cout, generator=g),
                       0.5 + torch.rand(cout, generator=g),
                       0.1 * torch.randn(cout, generator=g)))
        cin = cout
    return g, xe, used, params


@pytest.mark.parametrize("c0,dims,h,n_exp,case", CHAIN_CASES)
def test_conv1d_train_kernels(dev, c0, dims, h, n_exp, case):
    g, xe, used, params = _train_inputs(c0, dims, h, n_exp, case)
    xe, used = xe.to(dev), used.to(dev)
    params = [tuple(t.to(dev) for t in p) for p in params]
    cot = torch.randn(2, n_exp, dims[-1], generator=g).to(dev)
    # each pass against its plain version on the same inputs
    z_prev, bn_prev = xe, None
    for w, b, gam, bet in params:
        args = (z_prev, bn_prev, w, b, used, h)
        z, mean, var = conv1d_train.conv1d_train_fwd_layer(*args)
        r_z, r_mean, r_var = conv1d_train.conv1d_train_fwd_layer_ref(*args)
        assert _rel_err(z, r_z) <= 1e-4
        assert _rel_err(mean, r_mean) <= 1e-5 and _rel_err(var, r_var) <= 1e-5
        bn = (r_mean, torch.rsqrt(r_var + 1e-5), gam, bet)
        d_u = torch.randn(z.shape, generator=g).to(dev)
        z_s = z * (1 + 1e-5 * torch.randn(z.shape, generator=g).to(dev))
        red = conv1d_train.conv1d_train_bwd_reduce(d_u, r_z, bn, used)
        r_red = conv1d_train.conv1d_train_bwd_reduce_ref(d_u, r_z, bn, used)
        s_red = conv1d_train.conv1d_train_bwd_reduce_ref(d_u, z_s, bn, used)
        _yardstick_ok(red, r_red, s_red)
        c1, c2 = r_red[0] / used.sum(), r_red[1] / used.sum()
        t_args = (d_u, r_z, z_prev, bn, bn_prev, w, c1, c2, used, h)
        fuse = (bn_prev is not None
                and conv1d_train.fused_reduce(z_prev.shape[-1]))
        got = conv1d_train.conv1d_train_bwd_t(*t_args, prev_sums=fuse)
        _yardstick_ok(got[:3], conv1d_train.conv1d_train_bwd_t_ref(*t_args),
                      conv1d_train.conv1d_train_bwd_t_ref(
                          d_u, z_s, *t_args[2:]))
        if fuse:  # the previous layer's sums over the kernel's d_u_prev
            want = conv1d_train.conv1d_train_bwd_reduce_ref(
                got[0], z_prev, bn_prev, used)
            for a, b_ in zip(got[3], want):
                assert _rel_err(a, b_) <= 1e-3
        z_prev, bn_prev = r_z, bn
    # the chain through the autograd Function against torch autograd; at
    # the sweep's size (~10^7 BN outputs a layer) a few outputs lie within
    # rounding of leaky's kink, and one that takes the other branch moves
    # every gradient by ~1e-3 (BN's backward sums spread it), so there the
    # gradients get the passes' yardstick: 1e-3 plus 3x the plain chain's
    # change when xe moves by 1e-5 relative
    sweep = n_exp > 3000
    outs = []
    runs = [(conv1d_train.conv1d_chain_train, xe),
            (conv1d_train.conv1d_chain_train_ref, xe)]
    if sweep:
        runs.append((conv1d_train.conv1d_chain_train_ref, xe * (
            1 + 1e-5 * torch.randn(xe.shape, generator=g).to(dev))))
    for chain, x0 in runs:
        x = x0.clone().requires_grad_(True)
        ps = [[t.clone().requires_grad_(True) for t in p] for p in params]
        out, stats = chain(x, ps, used, h)
        (out * cot).sum().backward()
        outs.append((out.detach(),
                     [[t.detach() for t in s[:2]] for s in stats],
                     [x.grad] + [t.grad for p in ps for t in p]))
    (out, stats, grads), (r_out, r_stats, r_grads) = outs[:2]
    assert _rel_err(out, r_out) <= 1e-4
    for (m, v), (r_m, r_v) in zip(stats, r_stats):
        assert _rel_err(m, r_m) <= 1e-5 and _rel_err(v, r_v) <= 1e-5
    s_grads = outs[2][2] if sweep else r_grads
    for got, want, shaken in zip(grads, r_grads, s_grads):
        assert float((got - want).norm()) <= 1e-3 * max(
            float(want.norm()), 1e-3 * float(r_grads[0].norm())) + 3 * float(
                (shaken - want).norm())


@pytest.mark.parametrize("c0,h", [(262, 2), (32, 2), (5, 1)])
def test_conv1d_train_t_repeats_bitwise(dev, c0, h):
    """K8's t pass sums dW and db across blocks in a fixed order, and with
    an input at most DW_FUSED wide the previous layer's reduce sums too:
    two runs on the same inputs agree bit for bit (the layer input comes
    through a previous BN)."""
    dims = (32,) if h == 2 else (24,)
    g, xe, used, params = _train_inputs(c0, dims, h, 49164, "halo_end")
    w, b, gam, bet = (t.to(dev) for t in params[0])
    xe, used = xe.to(dev), used.to(dev)
    bn_prev = tuple(t.to(dev) for t in (
        0.1 * torch.randn(c0, generator=g), 1 + 0.1 * torch.rand(
            c0, generator=g), 0.5 + torch.rand(c0, generator=g),
        0.1 * torch.randn(c0, generator=g)))
    z, mean, var = conv1d_train.conv1d_train_fwd_layer(xe, bn_prev, w, b,
                                                       used, h)
    bn = (mean, torch.rsqrt(var + 1e-5), gam, bet)
    d_u = torch.randn(z.shape, generator=g).to(dev)
    c1 = 0.01 * torch.randn(z.shape[-1], generator=g).to(dev)
    c2 = 0.01 * torch.randn(z.shape[-1], generator=g).to(dev)
    args = (d_u, z, xe, bn, bn_prev, w, c1, c2, used, h)
    fuse = conv1d_train.fused_reduce(c0)
    first = conv1d_train.conv1d_train_bwd_t(*args, prev_sums=fuse)
    second = conv1d_train.conv1d_train_bwd_t(*args, prev_sums=fuse)
    assert len(first) == (4 if fuse else 3)
    for a, b_ in zip(first[:3], second[:3]):
        assert torch.equal(a, b_)
    if fuse:
        for a, b_ in zip(first[3], second[3]):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("c,widths", [(67, (64, 64, 64)), (131, (128, 128)),
                                      (256, (256, 256)), (5, (7,))])
@pytest.mark.parametrize("slow", [False, True])
def test_edge_mlp_kernel(dev, c, widths, slow):
    g = torch.Generator().manual_seed(9)
    n, k = 700, 21
    x = torch.randn(2, n, c, generator=g)
    idx = torch.randint(0, n, (2, n, k), generator=g, dtype=torch.int32)
    idx[:, :, 0] = torch.arange(n, dtype=torch.int32)
    idx[torch.rand(2, n, k, generator=g) < 0.3] = -1
    idx[:, 600:] = -1                      # padding queries: no live slot
    dims = (2 * c,) + widths
    weights = tuple(torch.randn(a, b, generator=g) / a ** 0.5
                    for a, b in zip(dims[:-1], dims[1:]))
    biases = tuple(0.1 * torch.randn(b, generator=g) for b in widths)
    if slow:     # the slow message order folded into W_0 (sparse sgcnn)
        weights = (edge_mlp.slow_order_transform(c) @ weights[0],) + \
            weights[1:]
    args = (x.to(dev), idx.to(dev), tuple(w.to(dev) for w in weights),
            tuple(b.to(dev) for b in biases))
    got = edge_mlp.fused_edge_mlp_max(*args)
    want = edge_mlp.fused_edge_mlp_max_ref(*args)
    assert bool((got[:, 600:] == -100.0).all())
    rest = want[want != -100.0]
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(rest.abs().max()))


# (rows, C, widths): the flagship's five admitted sgcnn steps (3 and 28,
# 6, 22, 25), K 21 with the self loop
EDGE_STEPS = [(23040, 67, (64, 64, 64)), (11520, 131, (128, 128)),
              (5760, 256, (256, 256)), (11520, 128, (128, 128))]


@pytest.mark.parametrize("n,c,widths", EDGE_STEPS)
def test_edge_mlp_kernel_at_flagship_steps(dev, n, c, widths):
    """K9 at the admitted steps' shapes: a self loop and 20 neighbours
    from a window of the row (10% dead), the row's last 15% padding
    queries with no live slot; within 1e-4 of the plain version, -100 at
    the padding queries, and a repeat run bit-equal."""
    g = torch.Generator().manual_seed(n + c)
    k, pad = 21, n - n * 85 // 100
    x = torch.randn(1, n, c, generator=g)
    base = torch.arange(n, dtype=torch.int32)[None, :, None]
    idx = (base + torch.randint(-200, 201, (1, n, k), generator=g,
                                dtype=torch.int32)).clamp(0, n - pad - 1)
    idx[..., 0] = base[..., 0]
    idx[torch.rand(1, n, k, generator=g) < 0.1] = -1
    idx[:, n - pad:] = -1
    dims = (2 * c,) + widths
    weights = tuple(torch.randn(a, b, generator=g) / a ** 0.5
                    for a, b in zip(dims[:-1], dims[1:]))
    biases = tuple(0.1 * torch.randn(b, generator=g) for b in widths)
    args = (x.to(dev), idx.to(dev), tuple(w.to(dev) for w in weights),
            tuple(b.to(dev) for b in biases))
    got = edge_mlp.fused_edge_mlp_max(*args)
    want = edge_mlp.fused_edge_mlp_max_ref(*args)
    assert bool((got[:, n - pad:] == -100.0).all())
    rest = want[want != -100.0]
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(rest.abs().max()))
    assert torch.equal(edge_mlp.fused_edge_mlp_max(*args), got)


def _raster_bits_equal(got, want):
    for g, w in zip(got, want):   # bit for bit: floats as int32 bits
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


# the box (12 faces, each over many tiles) at the generator's 2048, ragged
# sizes that are no multiple of the tile, and a ~10^5-face sphere (a dense
# mesh: hundreds of faces a tile)
@pytest.mark.parametrize("mesh,res", [("box", 2048), ("box", 100),
                                      ("cylinder", 130), ("sphere", 1000),
                                      ("dense", 2048), ("dense", 130)])
def test_rasterize_kernel_tiles(dev, mesh, res):
    verts, faces = (sim_generate.uv_sphere(n_lat=224, n_lon=224)
                    if mesh == "dense" else sim_generate.PRIMITIVES[mesh]())
    if mesh == "dense":
        assert len(faces) > 90000
    verts = verts - verts.mean(0)
    verts = verts / np.linalg.norm(verts, axis=1).max()
    pin = rasterizer.Pinhole(1.8 * res, 1.8 * res, res / 2, res / 2, res,
                             res)
    cam = rasterizer.look_at_camera(verts, distance=2.2)
    got = rasterizer.rasterize(cam, faces, pin, dev)
    want = rasterizer.rasterize_plain(cam, faces, pin, dev)
    assert int(want[2].sum()) > res * res // 8
    _raster_bits_equal(got, want)
    _raster_bits_equal(rasterizer.rasterize(cam, faces, pin, dev), got)


@pytest.mark.parametrize("mesh", sorted(sim_generate.PRIMITIVES))
def test_rasterize_kernel(dev, mesh):
    verts, faces = sim_generate.PRIMITIVES[mesh]()
    verts = verts - verts.mean(0)
    verts = verts / np.linalg.norm(verts, axis=1).max()
    pin = rasterizer.Pinhole(921.6, 921.6, 256.0, 256.0, 512, 512)
    for dist, elev, azim in [(2.2, 20.0, 30.0), (3.0, -25.0, 200.0)]:
        cam = rasterizer.look_at_camera(verts, distance=dist, elev_deg=elev,
                                        azim_deg=azim)
        got = rasterizer.rasterize(cam, faces, pin, dev)
        want = rasterizer.rasterize_plain(cam, faces, pin, "cpu")
        assert int(want[2].sum()) > 10000
        for g, w in zip(got, want):   # bit for bit: floats as int32 bits
            g = g.cpu()
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w)
