"""K3's and K6's designs on the CPU (``csrc/knn.cu``, ``csrc/fps.cu``),
held against the plain versions ``knn_search_ref`` / ``fps_picks_ref``.

The models below are the kernels' decisions, step for step, in the same
f32 arithmetic:

* K3: the f32 bounding box of each 32-point tile's valid points and of
  each super-tile of 32 tiles; one query a warp visits the super-tiles
  nearest first while one lies within min(k-th best, r2), and in each its
  tiles nearest first under the same test (box d2 <= the threshold: an
  equal box may still hold a tie at a lower index); the list ordered by
  (d2, index), since tiles are visited out of index order.
* K6: a row's valid points ranked in index order on one CTA of T
  threads, P points a thread (rank t + p * T), each thread's best by
  ascending p, each warp's argmax on (key, lowest rank) with the field's
  order-preserving key, the largest of the warps' (key, ~rank) slots, the
  stop once the largest field is 0 (every valid point picked) or no point
  is valid, and the ranks mapped to indices.

Tolerances: none.  Both kernels are exact: K3's distances equal the plain
version's bit for bit and its indices equal them except between equal
distances, K6's picks are equal.
"""

import numpy as np
import pytest
import torch

from curvecloudnet_tpu_torch.data.synthetic import lidar_sweep
from curvecloudnet_tpu_torch.ops import _build, fps, knn
from curvecloudnet_tpu_torch.ops.segments import sq_norm3, sqrt32

torch.set_num_threads(1)

TILE = knn.TILE
INF = float("inf")
NO_INDEX = 2 ** 32 - 1


# --- K3 --------------------------------------------------------------------

def tile_boxes(points, p_valid):
    """(lo, hi) (NT, 3) f32 over each tile's valid points; an empty tile
    gets lo = +inf, hi = -inf."""
    n = points.shape[0]
    nt = -(-n // TILE)
    pad = nt * TILE - n
    p = torch.cat([points, torch.zeros(pad, 3)])
    v = torch.cat([p_valid, torch.zeros(pad, dtype=torch.bool)])[:, None]
    lo = torch.where(v, p, INF).view(nt, TILE, 3).amin(1)
    hi = torch.where(v, p, -INF).view(nt, TILE, 3).amax(1)
    return lo, hi


def gap(lo, hi, q):
    """max(lo - q, q - hi, 0) per axis, f32 (numpy or torch)."""
    if isinstance(lo, np.ndarray):
        return np.maximum(np.maximum(lo - q, q - hi), np.float32(0))
    return torch.clamp(torch.maximum(lo - q, q - hi), min=0.0)


def norm2(d):
    """(x*x + y*y) + z*z over the last axis, f32."""
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[
        ..., 2]


def knn_model(query, points, q_valid, p_valid, k, radius):
    """One batch row: (idx (Q, k), dist (Q, k), tiles visited, tiles the
    valid queries could visit).  A query visits the super-tiles (32 tiles)
    nearest first while one is within min(k-th best, r2), and in each its
    tiles nearest first under the same test."""
    n_q, n = query.shape[0], points.shape[0]
    r2 = np.float32(knn._r2(radius))
    lo, hi = (t.numpy() for t in tile_boxes(points, p_valid))
    nt = lo.shape[0]
    ns = -(-nt // 32)
    pad = ns * 32 - nt
    s_lo = np.concatenate([lo, np.full((pad, 3), np.inf, np.float32)]).reshape(
        ns, 32, 3).min(1)
    s_hi = np.concatenate([hi, np.full((pad, 3), -np.inf, np.float32)]
                          ).reshape(ns, 32, 3).max(1)
    pts, pv = points.numpy(), p_valid.numpy()
    qs, qv = query.numpy(), q_valid.numpy()
    idx = np.full((n_q, k), -1, np.int64)
    dist = np.full((n_q, k), 1e30, np.float32)
    seen = total = 0
    inf = np.float32(np.inf)
    for q in range(n_q):
        if not qv[q]:
            continue
        total += nt
        ld = np.full(k, inf)
        li = np.full(k, -1, np.int64)
        sd = norm2(gap(s_lo, s_hi, qs[q]))
        while True:
            thr = min(ld[k - 1], r2)
            open_ = (sd <= thr) & (sd < inf)
            if not open_.any():
                break
            sup = int(np.argmin(np.where(open_, sd, inf)))
            sd[sup] = inf
            tiles = np.arange(sup * 32, min(sup * 32 + 32, nt))
            td = norm2(gap(lo[tiles], hi[tiles], qs[q]))
            while True:
                thr = min(ld[k - 1], r2)
                open_ = (td <= thr) & (td < inf)
                if not open_.any():
                    break
                t = int(np.argmin(np.where(open_, td, inf)))
                td[t] = inf
                j = np.arange(tiles[t] * TILE, min(tiles[t] * TILE + TILE, n))
                d2 = norm2(qs[q] - pts[j])
                ok = pv[j] & (d2 <= r2) & (d2 < inf)
                all_d = np.concatenate([ld, d2[ok]])
                all_i = np.concatenate([li, j[ok]])
                live = all_i >= 0
                o = np.lexsort((all_i, all_d))[:k]
                ld, li = all_d[o], np.where(live[o], all_i[o], -1)
                seen += 1
        good = li >= 0
        idx[q] = np.where(good, li, -1)
        dist[q] = np.where(good, sqrt32(torch.from_numpy(ld)).numpy(), 1e30)
    return torch.from_numpy(idx), torch.from_numpy(dist), seen, total


def sweep_row(seed, n_points, n_beams, keep=1.0, dup=0):
    """A synthetic lidar sweep in scan order (the port's data), a random
    ``keep`` share of it, a copy of ``dup`` consecutive points of its
    second half inserted near its start (exact ties in a tile of lower
    index, visited after the original's), padded by 37 invalid points."""
    rng = np.random.default_rng(seed)
    pos = lidar_sweep(rng, n_points, n_beams)[0]
    pos = pos[np.sort(rng.permutation(len(pos))[:int(keep * len(pos))])]
    if dup:
        at = int(rng.integers(len(pos) // 2, len(pos) - dup))
        pos = np.insert(pos, len(pos) // 20, pos[at:at + dup], axis=0)
    n = len(pos) + 37
    full = np.zeros((n, 3), np.float32)
    full[:len(pos)] = pos
    valid = np.zeros(n, bool)
    valid[:len(pos)] = True
    return torch.from_numpy(full), torch.from_numpy(valid)


def assert_knn_equal(got, want):
    (i_g, d_g), (i_w, d_w) = got, want
    assert torch.equal(d_g, d_w)
    assert not bool(((i_g != i_w.long()) & (d_g != d_w)).any())


# rows: the table of a scan-order row (own radius), its fp-style query set
# (every other point against the kept ones), a row with duplicates whose
# ties fall in tiles visited out of index order, and a row of randn points
# (no locality: every tile is visited)
@pytest.mark.parametrize("case", ["table", "query_set", "duplicates",
                                  "randn", "no_radius_table"])
def test_knn_model_matches_plain(case):
    pos, valid = sweep_row(0, 4096, 8, keep=0.6,
                           dup=100 if case == "duplicates" else 0)
    if case == "randn":
        pos = torch.randn((900, 3), generator=torch.Generator().manual_seed(1))
        valid = valid[:900]
    k, radius = (32, 0.04) if case in ("table", "duplicates", "randn") else (
        32, None)
    query, q_valid = pos, valid
    if case == "query_set":
        query, q_valid = pos[1::2].contiguous(), valid[1::2].contiguous()
        pos, valid = pos[::2].contiguous(), valid[::2].contiguous()
        k = 3
    want = knn.knn_search_ref(query[None], pos[None], q_valid[None],
                              valid[None], k, radius)
    i_m, d_m, seen, total = knn_model(query, pos, q_valid, valid, k, radius)
    assert_knn_equal((i_m[None], d_m[None]), want)
    share = seen / total
    if case == "randn":
        assert share > 0.5      # random rows defeat the boxes
    else:
        assert share < 0.25     # scan order: a few tiles a warp


@pytest.mark.parametrize("radius,k", [(1e-6, 8), (0.04, 40), (None, 5)])
def test_knn_model_edge_cases(radius, k):
    """A radius that admits no other point, k above the valid count, a
    ragged last tile (N no multiple of 32) and a warp of invalid queries."""
    pos, valid = sweep_row(2, 1024, 8, keep=0.05)
    k = min(k, 32)
    q_valid = valid.clone()
    q_valid[:32] = False
    want = knn.knn_search_ref(pos[None], pos[None], q_valid[None],
                              valid[None], k, radius)
    i_m, d_m, _, _ = knn_model(pos, pos, q_valid, valid, k, radius)
    assert_knn_equal((i_m[None], d_m[None]), want)
    assert pos.shape[0] % TILE


# --- K3's list for k > 32 (csrc/warp_list.cuh ListR<R>), lane by lane ----

def _before(d, i, bd, bi):
    return (d < bd) | ((d == bd) & (i < bi))


def _exchange(d, i, stride, first):
    """One compare-exchange of a bitonic network across the 32 lanes."""
    lane = np.arange(32)
    od, oi = d[lane ^ stride], i[lane ^ stride]
    take = _before(od, oi, d, i) == first
    return np.where(take, od, d), np.where(take, oi, i)


class WarpList:
    """The warp's list of the k <= 32 R best (d, i): slot 32 r + lane in
    register r of that lane, as ``insert_one`` and ``merge_all`` of
    ``ListR<R>`` keep it (ballots, shuffles and exchanges as numpy ops on
    the 32 lanes)."""

    def __init__(self, regs, k):
        self.regs, self.k = regs, k
        self.d = np.full((regs, 32), np.inf, np.float32)
        self.i = np.full((regs, 32), -1, np.int64)

    def entry(self, s):
        return self.d[s >> 5, s & 31], self.i[s >> 5, s & 31]

    def insert_one(self, cd, ci):
        lane, k = np.arange(32), self.k
        pos = -1
        for r in range(self.regs):
            after = (r * 32 + lane < k) & _before(cd, ci, self.d[r],
                                                  self.i[r])
            if after.any():
                pos = r * 32 + int(np.argmax(after))
                break
        if pos < 0:
            return
        d_prev, i_prev = np.float32(np.inf), -1
        for r in range(self.regs):
            if r * 32 + 31 < pos:
                continue
            if r * 32 >= k:
                break
            ud = np.concatenate([[d_prev], self.d[r][:-1]])
            ui = np.concatenate([[i_prev], self.i[r][:-1]])
            d_prev, i_prev = self.d[r][31], self.i[r][31]
            s = r * 32 + lane
            shift = (s > pos) & (s < k)
            self.d[r] = np.where(s == pos, cd, np.where(shift, ud, self.d[r]))
            self.i[r] = np.where(s == pos, ci, np.where(shift, ui, self.i[r]))

    def merge_all(self, cd, ci):
        lane, k = np.arange(32), self.k
        size = 2
        while size <= 32:
            stride = size >> 1
            while stride:
                first = ((lane & stride) == 0) == (((lane & size) == 0)
                                                   | (size == 32))
                cd, ci = _exchange(cd, ci, stride, first)
                stride >>= 1
            size <<= 1
        for r in range(self.regs):
            if r * 32 >= k or not (ci >= 0).any():
                break
            rd, ri = cd[31 - lane], ci[31 - lane]
            take = _before(rd, ri, self.d[r], self.i[r])
            ld, li = np.where(take, rd, self.d[r]), np.where(take, ri,
                                                             self.i[r])
            hd, hi = np.where(take, self.d[r], rd), np.where(take, self.i[r],
                                                             ri)
            for stride in (16, 8, 4, 2, 1):
                ld, li = _exchange(ld, li, stride, (lane & stride) == 0)
            self.d[r], self.i[r] = ld, li
            if r + 1 < self.regs and (r + 1) * 32 < k:
                for stride in (16, 8, 4, 2, 1):
                    hd, hi = _exchange(hd, hi, stride, (lane & stride) == 0)
            cd, ci = hd, hi
        past = np.arange(self.regs)[:, None] * 32 + lane >= k
        self.d[past], self.i[past] = np.inf, -1

    def visit(self, d2, idx):
        """A tile's 32 candidates as knn.cu's ``visit`` takes them: those
        before the k-th entry, one by one up to 4, else merged at once."""
        kd, ki = self.entry(self.k - 1)
        acc = (idx >= 0) & _before(d2, idx, kd, ki)
        if acc.sum() > 4:
            self.merge_all(np.where(acc, d2, np.float32(np.inf)),
                           np.where(acc, idx, -1))
            return
        for lane in np.nonzero(acc)[0]:
            self.insert_one(d2[lane], idx[lane])


@pytest.mark.parametrize("k", [33, 64, 100, 128])
@pytest.mark.parametrize("ties", [True, False])
def test_warp_list_above_32_keeps_the_k_first(k, ties):
    """Tiles of candidates in random index order (exact distance ties
    across registers when ``ties``): the list holds the k first by (d, i),
    slots past k empty, whether they came one by one or merged."""
    rng = np.random.default_rng(k + ties)
    regs = 2 if k <= 64 else 4
    wl = WarpList(regs, k)
    seen_d, seen_i = [], []
    order = rng.permutation(40 * 32)
    for t in range(40):
        d2 = (rng.integers(0, 60, 32).astype(np.float32) * np.float32(0.25)
              if ties else rng.random(32).astype(np.float32))
        if t >= 10 and t % 3:     # late tiles: few candidates get in
            d2 = d2 + np.float32(10.0 if ties else 0.9)
        idx = order[t * 32:(t + 1) * 32].astype(np.int64)
        idx[rng.random(32) < 0.1] = -1           # invalid lanes
        wl.visit(d2, idx)
        seen_d.append(d2[idx >= 0])
        seen_i.append(idx[idx >= 0])
        all_d, all_i = np.concatenate(seen_d), np.concatenate(seen_i)
        o = np.lexsort((all_i, all_d))[:k]
        flat_d, flat_i = wl.d.reshape(-1), wl.i.reshape(-1)
        np.testing.assert_array_equal(flat_d[:len(o)], all_d[o])
        np.testing.assert_array_equal(flat_i[:len(o)], all_i[o])
        assert (flat_i[len(o):] == -1).all()


@pytest.mark.parametrize("k,radius", [(64, 0.05), (128, 0.08), (128, None)])
def test_knn_model_ball_queries_match_plain(k, radius):
    """k > 32 (the version-1.0 ball queries): a query set against a
    scan-order row with duplicates, as the kernel's tile order visits it."""
    pos, valid = sweep_row(3, 4096, 8, keep=0.5, dup=60)
    query, q_valid = pos[::16].contiguous(), valid[::16].contiguous()
    want = knn.knn_search_ref(query[None], pos[None], q_valid[None],
                              valid[None], k, radius)
    i_m, d_m, _, _ = knn_model(query, pos, q_valid, valid, k, radius)
    assert_knn_equal((i_m[None], d_m[None]), want)
    if radius is not None:
        assert (want[0] >= 0).sum(-1).min() < k   # some balls not full


def _ulp_cloud(seed):
    """Points a few ulps apart around a few centres (their f32 bits moved
    by -4..4), a tight and a wide spread: (queries, points)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(6, 3)).astype(np.float32)
    bits = np.repeat(centres, 40, axis=0).view(np.int32)
    near = (bits + rng.integers(-4, 5, size=bits.shape).astype(
        np.int32)).view(np.float32)
    pts = np.concatenate([
        near, rng.normal(scale=1e-3, size=(64, 3)).astype(np.float32),
        (rng.normal(size=(64, 3)) * 50).astype(np.float32)])
    return torch.from_numpy(pts[::3].copy()), torch.from_numpy(pts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_distance_never_exceeds_members(seed):
    """The f32 query-to-box d2 never exceeds any member's sq_norm3 d2, and
    a super-tile's box (the union of its tiles' boxes) d2 never exceeds a
    tile's, for coordinates a few ulps apart as for spread ones."""
    query, points = _ulp_cloud(seed)
    g = torch.Generator().manual_seed(seed)
    for _ in range(20):
        members = points[torch.randperm(points.shape[0], generator=g)[:32]]
        lo, hi = members.amin(0), members.amax(0)
        box = norm2(gap(lo, hi, query))                       # (Q,)
        d2 = sq_norm3(query[:, None, :] - members[None])        # (Q, 32)
        assert bool((box[:, None] <= d2).all())
        others = points[torch.randperm(points.shape[0], generator=g)[:32]]
        s_lo = torch.minimum(lo, others.amin(0))
        s_hi = torch.maximum(hi, others.amax(0))
        assert bool((norm2(gap(s_lo, s_hi, query)) <= box).all())


def route_spread(points, p_valid):
    """The kernel's spread of a row (``brute_row``): for each of the first
    32 super-tiles with a valid point, the mean over its non-empty tiles
    of the share of the super-tile's box the tile's box fills (per axis
    (tile side / super side), 1 for a flat side), averaged."""
    n = points.shape[0]
    ns = -(-n // (32 * TILE))
    p = np.zeros((ns * 32 * TILE, 3), np.float32)
    v = np.zeros(ns * 32 * TILE, bool)
    p[:n], v[:n] = points, p_valid
    p, v = p.reshape(ns, 32, TILE, 3), v.reshape(ns, 32, TILE, 1)
    lo = np.where(v, p, np.inf).min(2)                  # (NS, 32, 3)
    hi = np.where(v, p, -np.inf).max(2)
    live = lo[..., 0] <= hi[..., 0]
    s_lo, s_hi = lo.min(1, keepdims=True), hi.max(1, keepdims=True)
    side = s_hi - s_lo
    with np.errstate(invalid="ignore", divide="ignore"):
        fill = np.where(side > 0, (hi - lo) / np.where(side > 0, side, 1),
                        1).prod(-1)
    count = live.sum(1)[:32]
    mean = np.where(live, fill, 0).sum(1)[:32] / np.maximum(count, 1)
    return float(mean[count > 0].mean())


def _route_row(kind, n, beams, seed=0):
    """A row of ``n`` slots: a synthetic sweep in scan order (every point
    valid, a quarter valid first, or a quarter valid scattered in order),
    the sweep shuffled, or randn points."""
    rng = np.random.default_rng(seed)
    if kind == "randn":
        return rng.normal(size=(n, 3)).astype(np.float32), np.ones(n, bool)
    pts = lidar_sweep(rng, 2 * n, beams)[0]
    pts = pts[np.sort(rng.permutation(len(pts))[:n])]
    valid = np.ones(n, bool)
    if kind == "shuffled":
        return pts[rng.permutation(n)], valid
    if kind == "quarter_first":
        valid[n // 4:] = False
        pts[:n // 4] = pts[np.sort(rng.permutation(n)[:n // 4])]
    elif kind == "quarter_scattered":
        valid[:] = False
        valid[rng.permutation(n)[:n // 4]] = True
    return pts, valid


# the rows the brute-force route is gated for (k <= 8, at least
# BRUTE_MIN_Q queries: the fp sets), against rows of 11520 to 36864 points
@pytest.mark.parametrize("kind,beams,n", [
    ("scan", 32, 36864), ("scan", 64, 18432), ("scan", 64, 11520),
    ("quarter_first", 64, 18432), ("quarter_scattered", 64, 36864),
    ("shuffled", 32, 36864), ("shuffled", 64, 11520), ("randn", 0, 18432)])
def test_route_spread_separates_scan_order(kind, beams, n):
    """A row in scan order keeps the tiled search (spread below
    ``BRUTE_SPREAD``), a row without that order takes the brute-force
    route; the CPU model reads the kernel's threshold."""
    import re
    from pathlib import Path

    src = (Path(knn.__file__).resolve().parent.parent / "csrc" /
           "knn.cu").read_text()
    assert float(re.search(r"#define KNN_BRUTE_SPREAD ([0-9.]+)f",
                           src).group(1)) == knn.BRUTE_SPREAD
    spread = route_spread(*_route_row(kind, n, beams))
    if kind in ("shuffled", "randn"):
        assert spread > knn.BRUTE_SPREAD
    else:
        assert spread < knn.BRUTE_SPREAD


def _insert(bd, bi, cd, ci, order_by_index):
    """Insert candidate (cd, ci) (one a query) into each query's sorted
    slots where it comes first: by d2 alone, strictly (a sweep in index
    order), or by (d2, index) (the merge)."""
    rows = np.arange(bd.shape[0])
    for s in range(bd.shape[1]):
        first = cd < bd[:, s]
        if order_by_index:
            first |= (cd == bd[:, s]) & (ci < bi[:, s])
        bd[rows, s], cd = np.where(first, cd, bd[:, s]), np.where(
            first, bd[:, s], cd)
        bi[rows, s], ci = np.where(first, ci, bi[:, s]), np.where(
            first, bi[:, s], ci)


def brute_model(query, points, q_valid, p_valid, k, radius, maxk,
                splits=4, chunk=256):
    """The brute-force route's lists: the row (padded to whole tiles) cut
    into ``splits`` parts of whole chunks; each part's points, in index
    order, inserted strictly into MAXK sorted slots a query (the first
    MAXK - k at -inf, the rest seeded with the first float above r2; an
    invalid point at d2 = inf); the parts' lists merged with the partner
    at distance 1, then 2, on (d2, index), skipping unfilled slots."""
    r2 = np.float32(knn._r2(radius))
    seed = np.nextafter(r2, np.float32(np.inf)) if np.isfinite(r2) else r2
    n_q, n = query.shape[0], -(-points.shape[0] // TILE) * TILE
    length = -(-n // (splits * chunk)) * chunk
    pts = np.zeros((n, 3), np.float32)
    pts[:points.shape[0]] = points.numpy()
    valid = np.zeros(n, bool)
    valid[:points.shape[0]] = p_valid.numpy()
    pts[~valid, 0] = np.inf
    qs = query.numpy()
    lists = []
    for part in range(splits):
        bd = np.tile(np.where(np.arange(maxk) < maxk - k, -np.inf,
                              seed).astype(np.float32), (n_q, 1))
        bi = np.full((n_q, maxk), -1, np.int64)
        for j in range(part * length, min((part + 1) * length, n)):
            cd = norm2(qs - pts[j]).astype(np.float32)
            take = cd < bd[:, -1]
            _insert(bd, bi, np.where(take, cd, np.inf).astype(np.float32),
                    np.where(take, j, -1), False)
        lists.append((bd, bi))
    m = 1
    while m < splits:
        merged = []
        for part in range(splits):
            bd, bi = (x.copy() for x in lists[part])
            od, oi = lists[part ^ m]
            for t in range(maxk):
                live = oi[:, t] >= 0
                _insert(bd, bi, np.where(live, od[:, t], np.inf).astype(
                    np.float32), np.where(live, oi[:, t], -1), True)
            merged.append((bd, bi))
        lists, m = merged, 2 * m
    bd, bi = lists[0]
    bd, bi = bd[:, maxk - k:], bi[:, maxk - k:]
    good = (bi >= 0) & q_valid.numpy()[:, None]
    dist = np.where(good, sqrt32(torch.from_numpy(bd)).numpy(), 1e30)
    return (torch.from_numpy(np.where(good, bi, -1)),
            torch.from_numpy(dist.astype(np.float32)))


@pytest.mark.parametrize("k,maxk,radius,dup", [
    (3, 4, None, 0), (4, 4, 0.3, 40), (5, 8, None, 40), (8, 8, 0.5, 0)])
def test_brute_model_matches_plain(k, maxk, radius, dup):
    """randn rows (the route's rows; 1500 points: parts of 512, the last
    short), with duplicated points (exact ties across parts, merged in
    index order), a radius, invalid points and queries; small chunks so a
    part spans several."""
    g = torch.Generator().manual_seed(k + dup)
    pos = torch.randn((1500, 3), generator=g)
    if dup:
        pos[torch.randperm(1500, generator=g)[:dup]] = pos[
            torch.randperm(1500, generator=g)[:dup]]
    valid = torch.rand(1500, generator=g) > 0.1
    query, q_valid = pos[::10].contiguous(), valid[1::10].contiguous()
    want = knn.knn_search_ref(query[None], pos[None], q_valid[None],
                              valid[None], k, radius)
    got = brute_model(query, pos, q_valid, valid, k, radius, maxk, chunk=128)
    assert_knn_equal((got[0][None], got[1][None]), want)


# --- K6 --------------------------------------------------------------------

def field_key(f):
    """The kernel's unsigned key of a field value: 0 for every negative
    value, else the float's bits + 1."""
    bits = f.view(torch.int32).long()
    return torch.where(f >= 0, bits + 1, torch.zeros_like(bits))


def fps_model(pos, valid, start, budget, config):
    """K6's decisions -> (B, budget): the valid points compacted in index
    order on one CTA of T threads, P points a thread (each warp's argmax
    as a (key, ~rank) slot, the largest slot wins); each thread's best by
    p ascending."""
    t, p = config
    assert t % 32 == 0 and t * p >= pos.shape[1]
    b = pos.shape[0]
    out = torch.empty((b, budget), dtype=torch.int32)
    for row in range(b):
        orig = torch.nonzero(valid[row])[:, 0]
        v = orig.numel()
        if v == 0:
            out[row] = 0
            out[row, 0] = int(start[row])
            continue
        pp, tt = torch.meshgrid(torch.arange(p), torch.arange(t),
                                indexing="ij")
        g = tt + pp * t                                 # (P, T) ranks
        real = g < v
        gc = torch.where(real, g, 0)
        pts = pos[row, orig]
        field = torch.full((v,), 1e30)
        last = int(start[row])
        for i in range(budget):
            out[row, i] = last
            if i + 1 == budget:
                break
            field = torch.minimum(field, sq_norm3(pts - pos[row, last]))
            f = torch.where(real, field[gc], -INF)
            bv = torch.full((t,), -INF)
            bi = torch.full((t,), NO_INDEX, dtype=torch.int64)
            for q in range(p):          # a thread's slots, p ascending
                take = f[q] > bv
                bv = torch.where(take, f[q], bv)
                bi = torch.where(take, g[q], bi)
            bk = field_key(bv).view(t // 32, 32)
            bi = bi.view(t // 32, 32)
            wk = bk.amax(-1, keepdim=True)       # a warp's two redux
            wi = torch.where(bk == wk, bi, NO_INDEX).amin(-1)
            # the largest (key, ~rank) slot
            best = int((wk[:, 0] * 2 ** 32 + (NO_INDEX - wi)).max())
            mk, win = best >> 32, NO_INDEX - (best & NO_INDEX)
            last = int(orig[win])
            if mk <= 1:
                out[row, i + 1:] = last
                break
    return out


def _fps_rows(n, valids, dup, seed):
    g = torch.Generator().manual_seed(seed)
    b = len(valids)
    pos = torch.zeros(b, n, 3)
    valid = torch.zeros(b, n, dtype=torch.bool)
    for row, nv in enumerate(valids):
        p, _ = sweep_row(seed + row, 2 * nv, 8, keep=0.5)
        p = p[:nv]
        if dup:
            p[torch.randperm(nv, generator=g)[:dup]] = p[
                torch.randperm(nv, generator=g)[:dup]]
        pos[row, :nv] = p
        valid[row, :nv] = True
        pos[row, nv:] = torch.randn(n - nv, 3, generator=g)   # junk, invalid
    return pos, valid


# (row size, valid counts of the B rows, budget, duplicated points, launch
# shape or None for launch_config's): ties across warps, B = 2 with
# different valid counts, budget equal to / above the valid count, ragged
# last slots (V no multiple of T), one warp (T = 32), a row with no valid
# point, more than 32 points a thread (their positions in shared memory)
FPS_CASES = [
    (700, (600,), 200, 150, (64, 12)),
    (700, (600, 411), 300, 0, (96, 8)),
    (500, (311,), 311, 0, (128, 4)),
    (500, (311, 250), 400, 40, (32, 16)),
    (300, (0, 200), 120, 0, (64, 8)),
    (700, (600,), 650, 100, (512, 2)),
    (1100, (900,), 250, 0, None),
    (2400, (2300,), 300, 60, (32, 76)),
]


@pytest.mark.parametrize("n,valids,budget,dup,config", FPS_CASES)
def test_fps_model_matches_plain(n, valids, budget, dup, config):
    pos, valid = _fps_rows(n, valids, dup, seed=n + budget)
    start = torch.tensor([min(7, max(v - 1, 0)) for v in valids],
                         dtype=torch.int32)
    config = config or fps.launch_config(n)
    want = fps.fps_picks_ref(pos, valid, start, budget)
    assert torch.equal(fps_model(pos, valid, start, budget, config), want)


def test_field_key_orders_the_field():
    vals = torch.tensor([-float("inf"), -1e30, -1.0, 0.0, 1e-45, 1e-30,
                         0.5, 1.0, 3e5, 1e30], dtype=torch.float32)
    keys = field_key(vals)
    assert int(keys[0]) == int(keys[1]) == int(keys[2]) == 0
    assert bool((keys[3:].diff() > 0).all()) and int(keys[3]) == 1


@pytest.mark.parametrize("n,threads", [
    (n, t) for n in (519, 1728, 5530, 5760, 18432, 23040, 36864)
    for t in (128, 256, 512, 1024)] + [(fps.SMEM_N, fps._THREADS),
                                       (fps.MAX_N, fps._THREADS)])
def test_fps_launch_config_covers_the_row(n, threads):
    """The main path's rows (A2D2's 23040-point row past the all-in-shared-
    memory limit; the largest the wrapper takes): ``launch_config``'s
    shape covers the row with the fewest points a thread the kernel is
    built for whose shared memory fits; at other widths
    ``tools/fps_sweep.py`` takes such a shape exactly where the kernel has
    one; a row past the wrapper's limit raises."""
    from curvecloudnet_tpu_torch.tools import fps_sweep

    built = [p for p, most in fps._POINTS.items() if threads <= most]
    swept = [c for c in fps_sweep.shapes(n) if c[0] == threads]
    assert len(swept) == (max(built) * threads >= n)
    for t, p in swept:
        assert t * p >= n and all(q * t < n for q in built if q < p)
    if n > fps.MAX_N:
        with pytest.raises(ValueError):
            fps.launch_config(n)
        return
    t, p = fps.launch_config(n)
    fits = [q for q in fps._POINTS if q * fps._THREADS >= n and
            fps.smem_bytes(n, fps._THREADS, q) <= _build.MAX_SMEM]
    if (t, p) == (fps._BIG_T, fps._BIG_P):   # past every other build
        assert not fits
    else:
        assert t == fps._THREADS and fps._POINTS[p] >= t and p == min(fits)
    assert t * p >= n and fps.smem_bytes(n, t, p) <= _build.MAX_SMEM
    with pytest.raises(ValueError):
        fps.launch_config(fps.MAX_N + 1)
