"""K2's 3xTF32 arithmetic on the CPU (``ops/group_reduce.py``
``tf32_round`` / ``tf32_split``, the split the wrapper hands the kernel).

* ``tf32_round`` rounds as the card's ``cvt.rna.tf32.f32``: to 10 mantissa
  bits, ties away from zero, bit for bit against an independent float64
  rounding and at constructed ties;
* hi + lo gives x back within f32 rounding (2^-22 relative: lo keeps
  lo's top 11 bits);
* a 3xTF32 product (lo*hi + hi*lo + hi*hi, each term exact in f32, summed
  in f32) at the sites' widths 64..1024 is within 1e-6 of the f64 product,
  relative to sum |a_i b_i|; a 1xTF32 product (hi*hi) is not, which is why
  the kernel pays three products.
"""

import numpy as np
import pytest
import torch

from curvecloudnet_tpu_torch.ops import group_reduce as G

WIDTHS = (64, 128, 192, 256, 512, 1024)


def _rna_f64(x: np.ndarray) -> np.ndarray:
    """Round normal f32 values to 11 significant bits, ties away from zero,
    in float64 arithmetic."""
    m, e = np.frexp(x.astype(np.float64))        # x = m 2^e, |m| in [0.5, 1)
    q = m * 2.0 ** 11
    q = np.sign(q) * np.floor(np.abs(q) + 0.5)
    return np.ldexp(q, e - 11).astype(np.float32)


def test_tf32_round_matches_rna():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200000) *
         10.0 ** rng.uniform(-30, 30, 200000)).astype(np.float32)
    got = G.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_f64(x))
    assert not (got.view(np.int32) & 0x1FFF).any()


@pytest.mark.parametrize("low,up", [(0x0FFF, False), (0x1000, True),
                                    (0x1001, True)])
def test_tf32_round_ties_away_from_zero(low, up):
    base = np.array([0x3F800000, 0x40490000, 0x3E2AA000], np.uint32)
    for sign in (0, 0x80000000):
        bits = (base | sign) + np.uint32(low)
        x = torch.from_numpy(bits.view(np.float32).copy())
        got = G.tf32_round(x).numpy().view(np.uint32)
        want = (base | sign) + np.uint32(0x2000 if up else 0)
        np.testing.assert_array_equal(got, want)


def test_tf32_round_passes_inf_and_nan():
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, -0.0])
    got = G.tf32_round(x)
    assert torch.equal(got[:2], x[:2]) and bool(torch.isnan(got[2]))
    assert torch.equal(got[3:].view(torch.int32), x[3:].view(torch.int32))


def test_tf32_split_reconstructs():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(100000).astype(np.float32))
    hi, lo = G.tf32_split(x)
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert bool((lo.abs() <= 2.0 ** -11 * x.abs()).all())


def _products(a, b):
    """(f64 product, 3xTF32 product, 1xTF32 product, sum |a_i b_i|):
    a (rows, n) @ b (n, cols), the TF32 terms summed in f32."""
    ah, al = G.tf32_split(a)
    bh, bl = G.tf32_split(b)
    exact = a.double() @ b.double()
    three = (al @ bh) + (ah @ bl) + (ah @ bh)
    one = ah @ bh
    scale = a.double().abs() @ b.double().abs()
    return exact, three, one, scale


@pytest.mark.parametrize("n", WIDTHS)
def test_3xtf32_product_within_1e6(n):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((32, n)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((n, 64)) / n ** 0.5)
                         .astype(np.float32))
    exact, three, one, scale = _products(a, b)
    rel3 = float(((three.double() - exact).abs() / scale).max())
    rel1 = float(((one.double() - exact).abs() / scale).max())
    assert rel3 <= 1e-6, rel3
    assert rel1 > 1e-6, rel1


# (layer widths, C_out, attend, K, rows a chunk, weight rows a stage): the
# flagship's sites
SITES = [((64, 128, 192, 256, 256, 256), 256, True, 25, 64, 32),
         ((64, 64, 64), 64, False, 21, 64, 32),
         ((256, 256, 128, 256), 256, True, 32, 64, 32),
         ((512, 512), 512, False, 21, 64, 16),
         ((512, 512, 512, 256, 512), 512, True, 32, 32, 16),
         ((1024, 1024, 1024), 1024, False, 32, 32, 8)]


@pytest.mark.parametrize("dims,c_out,attend,k,rows,kc", SITES)
def test_launch_shape_fits_the_block(dims, c_out, attend, k, rows, kc):
    """The widest chunk whose accumulators fit the registers (rows x the
    widest layer <= 32768) and whose buffers fit a block's 227 KB, with the
    deepest weight stage that fits; at most _MAX_TQ queries a block, as
    many as fill whole waves of one block on each of 132 SMs."""
    for queries, tq in ((519, 4), (23040, 59), (73728, 63)):
        assert G._launch_shape(dims, c_out, attend, k, queries,
                               132) == (rows, tq, kc)
        assert G._smem_bytes(rows, tq, kc, k, dims, c_out, attend) <= 232448
        blocks = -(-queries // tq)      # the waves are > 95% full
        assert blocks / (132 * -(-blocks // 132)) > 0.95
    assert rows * max(dims[1:]) <= 32768
    if rows < 64:
        assert (2 * rows * max(dims[1:]) > 32768 or
                G._smem_bytes(2 * rows, 1, 8, k, dims, c_out, attend) > 232448)
    if kc < 32:
        assert G._smem_bytes(rows, 1, 2 * kc, k, dims, c_out, attend) > 232448
