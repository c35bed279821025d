"""K7-bf16's host side on the CPU (``ops/group_train.py``): the weight
images ``pack_images`` packs once a call for the kernel's stages
(``csrc/group_train_wgmma.cuh``), the launch plans and their ints.

Each layer's image must hold W (the forward's dense) or W^T (the data
gradient's B) rounded to bfloat16, with zeros in the padding, at the byte
the kernel reads: the weight warp streams a product's stages in order
(each pass's slabs of 16 k, ``per`` a stage), and a consumer warpgroup's
wgmma descriptor reads output column n's 16 k of a slab at the pass's
row n - (first column of the pass), 32 bytes a row, its two 16-byte
chunks swapped where bit 2 of the row is set (the 32-byte swizzle).  W is
read where it lies, row-major or column-major (a Linear's weight.t()).
The kernel itself runs on the card (``tests/test_torch_port_cuda_bf16.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from curvecloudnet_tpu_torch.ops import _build
from curvecloudnet_tpu_torch.ops import group_reduce as GR
from curvecloudnet_tpu_torch.ops import group_train as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (chain [C1, widths...], attention width): ragged widths, 1024-wide
# layers, an attend chain, shapenet-seg's sa-geo site (its 1024-wide
# attention pair), layers of 257-448 columns (passes of 512, zero-padded)
CHAINS = [([36, 20, 44], 0), ([1024, 1024, 1024], 0), ([128, 128, 128], 64),
          ([64, 128, 256, 512, 1024], 1024), ([40, 384, 320], 448)]


def _weights(chain, att, seed=0):
    """The chain's (W (C_in, C_out), b) and, with ``att``, the attention
    pair (Wa0 (CL, att), Wa1 (att, CL))."""
    rng = np.random.default_rng(seed)
    shapes = list(zip(chain[:-1], chain[1:]))
    if att:
        shapes += [(chain[-1], att), (att, chain[-1])]
    return [(torch.from_numpy(rng.normal(size=(a, c)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=c).astype(np.float32)))
            for a, c in shapes]


def read_image(img, plan, k, n):
    """B (k, n) as the kernel reads it from ``img`` under ``plan``: the
    weight warp's byte offset of each stage (passes in order, ``per``
    slabs a stage), then for column c of pass p and depth kk the
    descriptor's row c - p * pw of slab kk // 16, the 32-byte swizzle;
    and the padding (columns past n, depth past k)."""
    raw = img.view(torch.int16).numpy()
    pw = 64 * plan["ns"]
    out = np.zeros((plan["nslab"] * 16, plan["npass"] * pw), np.int16)
    off = 0                          # bytes, as the weight warp counts them
    for p in range(plan["npass"]):
        for k0 in range(0, plan["nslab"], plan["per"]):
            slabs = min(plan["per"], plan["nslab"] - k0)
            assert slabs * pw * 32 <= plan["sb"]
            # (slab, row, half, element) of the stage, as wgmma reads it
            sl, row, half, e = np.meshgrid(np.arange(slabs), np.arange(pw),
                                           np.arange(2), np.arange(8),
                                           indexing="ij")
            chunk = half ^ ((row >> 2) & 1)
            at = (off + sl * pw * 32 + row * 32 + chunk * 16) // 2 + e
            out[(k0 + sl) * 16 + 8 * half + e, p * pw + row] = raw[at]
            off += slabs * pw * 32
    assert off == img.numel() * 2
    return out


def _bf16_bits(x):
    return x.to(torch.bfloat16).view(torch.int16).numpy()


@pytest.mark.parametrize("chain,att", CHAINS)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("colmajor", [False, True])
def test_image_round_trips(chain, att, transposed, colmajor):
    layers = _weights(chain, att)
    ws = [w.t().contiguous().t() if colmajor else w for w, _ in layers]
    assert all(w.is_contiguous() != colmajor for w in ws)
    images = G.pack_images(ws, None if transposed else [b for _, b in layers],
                           transposed, "cpu")
    for (w, b), (img, bias) in zip(layers, images):
        bw = w.t() if transposed else w
        k, n = bw.shape
        plan = G.plan_rows(k, n)
        got = read_image(img, plan, k, n)
        want = np.zeros_like(got)
        want[:k, :n] = _bf16_bits(bw)
        np.testing.assert_array_equal(got, want)
        pad = plan["npass"] * 64 * plan["ns"]
        assert bias.shape == (pad,)
        want_b = torch.zeros(pad)
        if not transposed:
            want_b[:n] = b
        assert torch.equal(bias, want_b)
        # the layer's own layout is group_reduce.pack_bf16's, at passes of
        # 512 columns past 256
        assert plan["ns"] == min(GR._ns((k, n)), 4) or plan["ns"] == 8
        if plan["ns"] == GR._ns((k, n)):
            ref, ref_b = GR.pack_bf16([(bw, want_b[:n])], "cpu")
            assert torch.equal(img.view(torch.int16), ref.view(torch.int16))


def _products(chain, att):
    """Every (K, N) of the chain's forward and data-gradient products."""
    shapes = [(w.shape[0], w.shape[1]) for w, _ in _weights(chain, att)]
    return shapes + [(n, k) for k, n in shapes]


@pytest.mark.parametrize("chain,att", CHAINS)
def test_plan_rows_fits(chain, att):
    for k, n in _products(chain, att):
        p = G.plan_rows(k, n)
        assert p["smem"] <= _build.MAX_SMEM
        assert 1 <= p["nst"] <= G.GTW_MAXST and p["sb"] % 1024 == 0
        # one warpgroup up to 256 columns: the image whole, or a ring of 2
        # stages (a slot is refilled after the next stage's products are
        # issued)
        one = p["ns"] <= 4
        assert p["kind"] == (G.GTW_ROWS1 if one else G.GTW_ROWS2)
        assert one or p["ns"] == 8          # gtw_rows is built for ns 8
        assert not one or p["nst"] <= 2 and (p["resident"] or p["nst"] == 2)
        assert p["npass"] * 64 * p["ns"] >= n > (p["npass"] - 1) * 64 * p[
            "ns"]
        assert p["nslab"] * 16 >= k and p["atiles"] * 64 >= k
        stages = p["npass"] * -(-p["nslab"] // p["per"])
        assert p["resident"] == int(stages <= p["nst"])
        # the shared-memory layout from a 1024-aligned base: the A tile,
        # the ring, the column sums of 64 ns columns and two staging tiles
        # a consumer warpgroup, the barriers (full, and with a weight warp
        # empty, a stage)
        assert p["w_off"] == p["atiles"] * GR.GW_TILE
        assert p["red_off"] == p["w_off"] + p["nst"] * p["sb"]
        assert p["bar_off"] == p["red_off"] + 2 * 8 * 32 * p["ns"] * 4 + (
            1 if one else 2) * 2 * GR.GW_TILE
        assert p["smem"] == 1024 + p["bar_off"] + 8 * p["nst"] * (
            1 if one else 2)


@pytest.mark.parametrize("rows", [0, 1, 65, 7595, 331992])
@pytest.mark.parametrize("k,n", [(36, 20), (64, 64), (128, 256),
                                 (1024, 1024), (259, 512)])
def test_plan_wgrad_fits(rows, k, n):
    p = G.plan_wgrad(rows, k, n, 132)
    assert p["smem"] <= _build.MAX_SMEM and p["ns"] in (2, 4, 8)
    assert 32 * p["ns"] >= min(n, 256)
    assert p["rps"] % G.GTW_ROWS == 0 and p["splits"] >= 1
    assert p["splits"] == max(1, -(-rows // p["rps"]))


@pytest.mark.parametrize("k,n", [(1025, 64), (64, 1025), (0, 64)])
def test_plans_refuse(k, n):
    with pytest.raises(ValueError):
        G.plan_rows(k, n)
    with pytest.raises(ValueError):
        G.plan_wgrad(100, k, n, 132)


def test_plan_ints_match_c_struct():
    """``GTW_FIELDS`` names ``GtwPlan``'s ints in the order the header
    declares them, and the kernel reads that many."""
    src = open(os.path.join(REPO, "curvecloudnet_tpu_torch", "csrc",
                            "group_train_wgmma.cuh")).read()
    body = src[src.index("struct GtwPlan {"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")])
    fields = [f.strip() for decl in body.split("{", 1)[1].split(";")
              for f in decl.replace("int ", "").split(",") if f.strip()]
    assert tuple(fields) == G.GTW_FIELDS
    plan = G.plan_rows(259, 512, 1, 0, 1)
    assert G.plan_ints(plan) == [plan[f] for f in fields]
    assert "nplan != (int)(sizeof(GtwPlan) / sizeof(int))" in open(
        os.path.join(REPO, "curvecloudnet_tpu_torch", "csrc",
                     "group_train.cu")).read()
