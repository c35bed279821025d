"""The port's grid-hash kNN (``ops/grid_knn.py``, kernels K5 and K10 in
``ops/grid_topk.py``) against the JAX package's on the CPU.

On CPU tensors the kernel wrappers run their plain versions.  Inputs are
numpy draws from a seed, handed to both packages.

* cell coordinates, buckets, the record table (every row but the parked
  one, which the JAX package overwrites in no fixed order and nobody
  reads), the stencil rows and the drop counts are identical, with forced
  hash collisions (``hash_bits=4``) and cap spills (small caps, 0 and 2
  overflow planes);
* neighbor tables equal the JAX package's, through its CPU (XLA) tail and
  through its Pallas records kernel in interpret mode (both payload
  schemes), except inside the JAX package's distance quantization band:
  its packed extraction clears the low log2(next_pow2(W)) (XLA tail, the
  column scheme) or log2(next_pow2(idx_bound)) (index payload) mantissa
  bits of d2, so a point whose d2 lies within that relative band of the
  k-th distance or the radius may be in one table and not the other;
* K10's plain version equals ``pallas_topk.topk_smallest`` in interpret
  mode exactly on values its quantization leaves unchanged (ties and
  1e30 fills included), and up to the band on arbitrary values;
* the per-row grid bounds and caps, the voxel occupancy proof and the
  dispatch rule above ``TABLE_MAX_N`` equal the JAX package's.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.models import base as jbase
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.ops import grid_knn as jgrid
from curvecloudnet_tpu.ops import neighbors as jnbrs
from curvecloudnet_tpu.ops import pallas_topk
from curvecloudnet_tpu_torch.models import base as tbase
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.ops import grid_knn as tgrid
from curvecloudnet_tpu_torch.ops import grid_topk
from curvecloudnet_tpu_torch.ops import neighbors as tnbrs

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(seed, n=700, q=300, spread=1.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    qry = (pts[:q] + rng.normal(0, 0.02, (q, 3))).astype(np.float32)
    return pts, qry, rng.random(q) > 0.1, rng.random(n) > 0.1


def _band(bits: int) -> float:
    """Relative d2 band of a packed extraction that clears ``bits`` low
    mantissa bits (plus a few f32 roundings)."""
    return 2.0 ** (bits - 23) + 1e-6


def _pow2_bits(w: int) -> int:
    return max(0, int(w - 1).bit_length())


def assert_grid_tables_agree(idx_t, dist_t, idx_j, dist_j, q_pos, p_pos,
                             q_valid, radius, rel):
    """Per query: equal neighbor sets except points whose exact d2 lies
    within ``rel`` (relative) of the cut, the k-th distance or radius^2;
    distances of shared neighbors within ``rel`` of each other."""
    idx_t, idx_j = np.asarray(idx_t), np.asarray(idx_j)
    dist_t, dist_j = np.asarray(dist_t), np.asarray(dist_j)
    assert idx_t.shape == idx_j.shape
    q64, p64 = q_pos.astype(np.float64), p_pos.astype(np.float64)
    r2 = radius * radius
    for b, q in zip(*np.nonzero(q_valid)):
        ti, ji = idx_t[b, q], idx_j[b, q]
        a, c = set(ti[ti >= 0].tolist()), set(ji[ji >= 0].tolist())
        both = sorted(a & c)
        if both:
            dt = {i: dist_t[b, q][list(ti).index(i)] ** 2 for i in both}
            dj = {i: dist_j[b, q][list(ji).index(i)] ** 2 for i in both}
            for i in both:
                assert abs(dt[i] - dj[i]) <= rel * dt[i] + 1e-12, (b, q, i)
        if a == c:
            continue
        d2 = {j: float(((q64[b, q] - p64[b, j]) ** 2).sum()) for j in a | c}
        kth = max(d2.values())
        for j in a ^ c:
            near_k = abs(d2[j] - kth) <= rel * kth + 1e-12
            near_r = abs(d2[j] - r2) <= rel * r2 + 1e-12
            assert near_k or near_r, (b, q, j, d2[j], kth, r2)


@pytest.mark.parametrize("cell", [0.04, 0.08, 0.1, 0.3])
def test_cells_and_buckets_match_jax(cell):
    """Cell coordinates (clipped at +-64 cells: points span +-4 units) and
    hash buckets at the table sizes the KITTI rows use."""
    pts = _cloud(1, n=4000, spread=4.0)[0]
    jc = jgrid._cell_coords(jnp.asarray(pts), cell)
    tc = tgrid.cell_coords(torch.from_numpy(pts), cell)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for bits in (4, 13, 14, 15):
        np.testing.assert_array_equal(
            tgrid.bucket(tc, bits).numpy(), np.asarray(jgrid._bucket(jc, bits)))
    for n in (1000, 36864, 73728, 131072, 1 << 22):
        assert tgrid.default_hash_bits(n) == jgrid.default_hash_bits(n)


@contextlib.contextmanager
def _jax_records(idx_bound=None):
    """Run the JAX grid search's accelerator tail (the Pallas records kernel,
    interpret mode) on the CPU; record the table and stencil rows it is
    handed.  ``idx_bound`` overrides the payload bound (above 2^17: the
    column scheme)."""
    seen = {}
    real, backend = pallas_topk.grid_topk_records, jax.default_backend

    def stub(table, nbr, query, q_valid, k, cap, radius, idx_bound=0, **kw):
        seen["table"], seen["nbr"] = np.asarray(table), np.asarray(nbr)
        seen["idx_bound"] = bound = override or idx_bound
        return real(table, nbr, query, q_valid, k, cap, radius,
                    idx_bound=bound, interpret=True)

    override = idx_bound
    pallas_topk.grid_topk_records = stub
    jax.default_backend = lambda: "tpu"
    try:
        yield seen
    finally:
        pallas_topk.grid_topk_records, jax.default_backend = real, backend


# (stencil, overflow planes, hash bits, cap, radius, payload bound override)
RECORD_CASES = [(27, 0, 4, 8, 0.3, None), (27, 2, 4, 8, 0.3, 1 << 18),
                (8, 2, None, 8, 0.15, None), (8, 0, 4, 16, 0.15, 1 << 18),
                (27, 2, None, 64, 0.3, None)]


@pytest.mark.parametrize("stencil,planes,bits,cap,radius,bound", RECORD_CASES)
def test_table_and_records_kernel_match_jax(stencil, planes, bits, cap,
                                            radius, bound):
    pts, qry, qv, pv = _cloud(2)
    k = 12
    with _jax_records(bound) as seen:
        ji, jd, jn = jgrid.grid_knn_single(
            jnp.asarray(qry), jnp.asarray(pts), jnp.asarray(qv),
            jnp.asarray(pv), k, radius, cap=cap, stencil=stencil,
            hash_bits=bits, overflow_planes=planes)
    hb = bits or tgrid.default_hash_bits(len(pts))
    cell = radius if stencil == 27 else 2 * radius
    table, counts, row, slot, nd = tgrid.build_table(
        torch.from_numpy(pts)[None], torch.from_numpy(pv)[None], cell, cap,
        hb, planes)
    nbr = tgrid.stencil_rows(torch.from_numpy(qry)[None], radius, cell,
                             stencil, hb, planes)[0]
    np.testing.assert_array_equal(nbr.numpy(), seen["nbr"])
    assert int(nd[0]) == int(jn)
    # the JAX table: rows [x*cap, y*cap, z*cap, biased idx*cap]
    jt = seen["table"].reshape(-1, 4, cap).transpose(0, 2, 1)
    jidx = (jt[..., 3].copy().view(np.int32) & 0x7FFFFF) - 1
    tt = table.numpy()
    live = np.arange(len(tt)) != (1 << hb)          # all but the parked row
    np.testing.assert_array_equal(tt[live][..., :3], jt[live][..., :3])
    np.testing.assert_array_equal(tt[live][..., 3].view(np.int32), jidx[live])
    np.testing.assert_array_equal(
        counts.numpy()[live], (jidx[live] >= 0).sum(-1))
    ti, td, _ = tgrid.grid_knn(
        torch.from_numpy(qry)[None], torch.from_numpy(pts)[None],
        torch.from_numpy(qv)[None], torch.from_numpy(pv)[None], k, radius,
        cap=cap, stencil=stencil, hash_bits=bits, overflow_planes=planes)
    w = nbr.shape[1] * cap
    bound = seen["idx_bound"]
    rel = _band(_pow2_bits(bound if 0 < bound <= 1 << 17 else w))
    assert_grid_tables_agree(ti, td, np.asarray(ji)[None],
                             np.asarray(jd)[None], qry[None], pts[None],
                             qv[None], radius, rel)


@pytest.mark.parametrize("stencil,planes", [(27, 2), (8, 2), (27, 0)])
def test_grid_knn_matches_jax_xla_tail(stencil, planes):
    """Batched (B=2), both port tails against the JAX CPU tail."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (2, 600, 3)).astype(np.float32)
    qry = pts[:, :250] + rng.normal(0, 0.02, (2, 250, 3)).astype(np.float32)
    qv, pv = rng.random((2, 250)) > 0.1, rng.random((2, 600)) > 0.1
    k, radius, cap = 10, 0.25, 16
    ji, jd = jax.jit(jgrid.grid_knn, static_argnums=(4, 5, 6, 7, 8, 9))(
        *map(jnp.asarray, (qry, pts, qv, pv)), k, radius, cap, stencil, None,
        planes)
    args = tuple(map(torch.from_numpy, (qry, pts, qv, pv)))
    outs = [tgrid.grid_knn(*args, k, radius, cap=cap, stencil=stencil,
                           overflow_planes=planes, tail=tail)
            for tail in tgrid.TAILS]
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    w = (stencil + planes) * cap
    assert_grid_tables_agree(outs[0][0], outs[0][1], ji, jd, qry, pts, qv,
                             radius, _band(_pow2_bits(w)))


def test_dense_cells_spill_and_drop():
    """A dense cluster overflows the cap: spills fill the overflow rows in
    point order, the rest is dropped and counted, as in the JAX package."""
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.normal(0.05, 0.005, (300, 3)),
                          rng.uniform(-1, 1, (300, 3))]).astype(np.float32)
    pv = np.ones(600, bool)
    search = jax.jit(jgrid.grid_knn_single, static_argnums=(4, 5, 6, 7, 8, 9))
    for planes in (0, 2):
        _, _, jn = search(jnp.asarray(pts[:50]), jnp.asarray(pts),
                          jnp.ones(50, bool), jnp.asarray(pv), 8, 0.1, 32, 27,
                          None, planes)
        _, _, row, slot, nd = tgrid.build_table(
            torch.from_numpy(pts)[None], torch.from_numpy(pv)[None], 0.1, 32,
            13, planes)
        assert int(nd[0]) == int(jn) > 0
        spilled = np.nonzero((row[0] > 1 << 13).numpy())[0]
        assert len(spilled) == 32 * planes
        place = (row[0, spilled] - (1 << 13) - 1) * 32 + slot[0, spilled]
        np.testing.assert_array_equal(place.numpy(), np.arange(32 * planes))


@pytest.mark.parametrize("k,w,ties", [(8, 300, True), (32, 928, True),
                                      (20, 700, False)])
def test_topk_smallest_matches_pallas(k, w, ties):
    rng = np.random.default_rng(5)
    q = 96
    if ties:
        # multiples of 1/8 below 4: the Pallas quantization keeps them
        d = (rng.integers(0, 32, (q, w)) / 8).astype(np.float32)
    else:
        d = rng.uniform(0, 1, (q, w)).astype(np.float32)
    d[rng.random((q, w)) < 0.6] = 1e30
    d[:3] = 1e30                                        # rows with nothing
    idx = rng.integers(0, 10000, (q, w)).astype(np.int32)
    jd, ji = pallas_topk.topk_smallest(jnp.asarray(d), jnp.asarray(idx), k,
                                       interpret=True)
    td, ti = grid_topk.topk_smallest(torch.from_numpy(d),
                                     torch.from_numpy(idx), k)
    jd, ji = np.asarray(jd), np.asarray(ji)
    if ties:
        np.testing.assert_array_equal(td.numpy(), jd)
        np.testing.assert_array_equal(ti.numpy(), ji)
        return
    np.testing.assert_array_equal(ti.numpy() >= 0, ji >= 0)
    live = ji >= 0
    rel = _band(_pow2_bits(w))
    np.testing.assert_allclose(td.numpy()[live], jd[live], rtol=rel)
    # a different index only where the two values lie within the band
    for r, s in zip(*np.nonzero(live & (ti.numpy() != ji))):
        assert abs(float(td[r, s]) - jd[r, s]) <= rel * jd[r, s]


def _specs(name):
    mc = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))["model"]
    return jparse(mc, in_dim=4, n_out=20), tparse(mc, in_dim=4, n_out=20)


@pytest.mark.parametrize("config", ["nuscenes", "kitti"])
def test_row_radius_bounds_match_jax(config):
    jspec, tspec = _specs(config)
    want = jbase._row_radius_bounds(jspec)
    assert tuple(tbase.row_radius_bounds(tspec)) == tuple(want)
    if config == "kitti":
        # the voxel-0.025 row's table: bound 0.1, proven cap 64
        assert (0.1, 64) in set(zip(want[1], want[2]))


def test_voxel_cell_occupancy_matches_jax():
    for cell in (0.02, 0.04, 0.07, 0.08, 0.1, 0.15, 0.3):
        for v in (0.01, 0.025, 0.03, 0.07, 0.11):
            assert (tbase._voxel_cell_occupancy(cell, v)
                    == jbase._voxel_cell_occupancy(cell, v)), (cell, v)


def test_dispatch_above_table_rows_matches_jax(monkeypatch):
    """Above TABLE_MAX_N the port takes the grid exactly where the JAX
    package does on the accelerator; at or below it the port stays exact
    (the TPU-only grid8 route is not taken)."""
    monkeypatch.setattr(jnbrs.jax, "default_backend", lambda: "tpu")
    assert tnbrs.TABLE_MAX_N == jnbrs.BRUTE_MAX_N == jnbrs.TABLE_MAX_N
    for n in (24577, 36864, 40960, 40961, 73728, 131072):
        for r in (0.04, 0.1, 0.15, 0.3, None):
            want = jnbrs._pick_backend(3, r, n) == "grid"
            assert (tnbrs.search_kernel(n, r) == "grid_topk") == want, (n, r)
    assert tnbrs.search_kernel(24576, 0.04) == "knn"
    assert tnbrs.search_kernel(8000, 0.1, cap=64) == "grid_topk"
    assert tnbrs.grid_cap(32) == jnbrs.grid_cap(32)
    for r, bound in [(0.08, 0.1), (0.1, 0.1), (0.3, 0.1), (0.04, None)]:
        want = jnbrs._grid_table_radius(r, bound)
        cap = 64 if want == bound else None
        assert tnbrs.grid_table_args(r, bound, 64) == (want, cap)


def test_kernels_raise_without_a_card():
    """No quiet CPU fallback: a non-CPU tensor goes to the kernel or
    raises."""
    t = torch.zeros(8, 4, 4, device="meta")
    c = torch.zeros(8, dtype=torch.int32, device="meta")
    nbr = torch.zeros(4, 2, dtype=torch.int32, device="meta")
    q = torch.zeros(4, 3, device="meta")
    qv = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        grid_topk.grid_topk_records(t, c, nbr, q, qv, 4, 0.01)
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        grid_topk.topk_smallest(q, q.int(), 2)
