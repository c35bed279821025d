"""K1-bf16 and K4b-bf16 as designed for the H100, modelled on the CPU.

K1-bf16 (``csrc/conv1d_chain.cu``): the taps image its pack kernel writes
(``ops/conv_tc.pack_image_bf16``, read back by ``image_layer_bf16``), the
launch plan (``conv1d_chain.plan_bf16``: the fields of ``struct CbPlan``
in order; every width the parent's kernel admitted still admitted), and
the chain's schedule (``conv_tc.chain_eval_model_bf16``: the pairs formed
from input chunks, the float32 sums in the kernel's order) against the
plain version and the Pallas kernel in interpret mode on the same
bfloat16 input: within one bfloat16 ulp at the output's scale, under 1%
of the elements differing.

K4b-bf16 (``csrc/gather.cu``): the inverse table (``gather.inverse_table``,
each source row's slots ascending) and the fixed-order sum
(``gather.scatter_km_table``) equal to the plain version bit for bit,
held against ``gather_rows``' VJP in interpret mode, the same bits on a
second run.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvecloudnet_tpu.ops import pallas_conv1d, pallas_gather
from curvecloudnet_tpu_torch.ops import _build, conv1d_chain, conv_tc, gather

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLIP_SHARE = 0.01      # elements a sum order may move by one rounding


def bf16_ulp(scale: float) -> float:
    """One bfloat16 ulp (8 significant bits) at ``scale``."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _hold_ulp(got, want, name):
    """got within one bfloat16 ulp of want at max(1, max |want|), under
    FLIP_SHARE of the elements differing at all."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    diff = np.abs(got - want)
    scale = max(1.0, float(np.abs(want).max()))
    assert diff.max() <= bf16_ulp(scale), (name, diff.max(), scale)
    assert (diff > 0).mean() < FLIP_SHARE, (name, (diff > 0).mean())


# ---------------------------------------------------------------------------
# K1-bf16
# ---------------------------------------------------------------------------


def _chain(seed, c0, dims, h, n_exp, b=2):
    """(xe (b, n_exp, c0) bfloat16 from numpy, f32 weights ((h+1) C_in x
    C_out, C_out) a layer)."""
    rng = np.random.default_rng(seed)
    xe = torch.from_numpy(rng.normal(size=(b, n_exp, c0)).astype(
        np.float32)).to(torch.bfloat16)
    weights, cin = [], c0
    for cout in dims:
        w = rng.normal(size=((h + 1) * cin, cout)) / np.sqrt((h + 1) * cin)
        weights.append((torch.from_numpy(w.astype(np.float32)),
                        torch.from_numpy((0.1 * rng.normal(size=cout)).astype(
                            np.float32))))
        cin = cout
    return xe, weights


# (C0, layer widths, h, n_exp, used): step_31's shape scaled down (C0 262
# -> 22, not a multiple of 8; three layers), an input of two 64-column
# chunks, one tap a side, a sample with no live slot; ``used`` cuts tiles
K1_CASES = [(22, (16, 16, 12), 2, 300, [290, 171]),
            (70, (24, 16), 1, 257, [257, 100]),
            (5, (16, 24), 1, 130, [0, 119])]


def test_k1_bf16_plan_fields_match_the_kernel_struct():
    src = open(os.path.join(REPO, "curvecloudnet_tpu_torch", "csrc",
                            "conv1d_chain.cu")).read()
    body = re.search(r"struct CbPlan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = [f.split("[")[0].strip() for decl in body.split(";")
              if decl.strip() for f in decl.strip()[len("int "):].split(",")]
    assert tuple(fields) == conv1d_chain.PLAN_FIELDS
    plan = conv1d_chain.plan_bf16([262, 32, 32, 32], 2)
    # dims, toff and boff padded to the most layers
    assert len(conv1d_chain.plan_ints(plan)) == len(fields) - 3 + (
        conv1d_chain.MAX_LAYERS + 1) + 2 * conv1d_chain.MAX_LAYERS
    # step_31: tiles of 256 slots (16 warps), every layer's taps resident
    # beside the ring
    assert (plan["rows"], plan["resident"]) == (256, 1)
    assert plan["stages"] >= 3
    assert plan["smem"] <= _build.MAX_SMEM


def _parent_admits(dims, h):
    """The parent kernel's admission (its ``_bf16_smem``): two activation
    buffers (row strides 8 mod 64 halves) and one layer's packed taps."""
    def ld(c):
        return -(-c // 64) * 64 + 8
    later = max(dims[1:])
    act = conv1d_chain.ROWS * (max(ld(dims[0]), ld(later)) + ld(later)) * 2
    taps = max((h + 1) * -(-ci // 16) * 8 * (-(-co // 8) * 8 + 8) * 4
               for ci, co in zip(dims[:-1], dims[1:]))
    return act + taps <= _build.MAX_SMEM


def test_k1_bf16_plan_admits_what_the_parent_admitted():
    admitted = 0
    for h in (1, 2, 3, 4):
        for n_layers in (1, 2, 3, 8):
            if conv1d_chain.ROWS - 2 * h * n_layers < 1:
                continue
            for c0 in (1, 5, 22, 100, 136, 262, 520):
                for w in (8, 24, 32, 72, 120, 128):
                    for last in (w, 16, 128):
                        dims = [c0] + [w] * (n_layers - 1) + [last]
                        if not _parent_admits(dims, h):
                            continue
                        admitted += 1
                        plan = conv1d_chain.plan_bf16(dims, h)
                        assert plan["smem"] <= _build.MAX_SMEM
    assert admitted > 300


def test_k1_bf16_image_holds_the_rounded_weights():
    h = 2
    _, weights = _chain(1, 22, (16, 12, 40), h, 10)
    plan, img = conv_tc.pack_image_bf16(weights, h)
    assert plan["total"] % 4 == 0 and all(t % 4 == 0 for t in plan["toff"])
    for l, (w, b) in enumerate(weights):
        taps, bias = conv_tc.image_layer_bf16(plan, img, l, h)
        cin = w.shape[0] // (h + 1)
        want = w.to(torch.bfloat16).float().reshape(h + 1, cin, -1)
        assert torch.equal(taps[:, :cin], want)
        assert not taps[:, cin:].any()       # 0 past C_in (to 16)
        assert torch.equal(bias, b)


@pytest.mark.parametrize("c0,dims,h,n_exp,used", K1_CASES)
def test_k1_bf16_model_matches_plain_and_pallas(c0, dims, h, n_exp, used):
    xe, weights = _chain(7, c0, dims, h, n_exp)
    u = torch.tensor(used, dtype=torch.int32)
    got = conv_tc.chain_eval_model_bf16(xe, weights, u, h)
    assert got.dtype == torch.bfloat16
    _hold_ulp(got.float(), conv1d_chain.conv1d_chain_eval_ref(
        xe, weights, u, h).float(), "plain")
    for b, ub in enumerate(used):
        want = pallas_conv1d.conv1d_chain_eval(
            jnp.asarray(xe[b].float().numpy(), jnp.bfloat16),
            [(jnp.asarray(w.numpy()), jnp.asarray(bb.numpy()))
             for w, bb in weights], jnp.int32(ub), half_k=h, interpret=True)
        assert want.dtype == jnp.bfloat16
        _hold_ulp(got[b].float(), np.asarray(want.astype(jnp.float32)),
                  f"pallas sample {b}")
        # dead slots and the rows past ``used`` hold exactly 0
        assert not got[b, ub:].any()


# ---------------------------------------------------------------------------
# K4b-bf16
# ---------------------------------------------------------------------------


def _k4b(seed, n, k, c):
    """(d_out (k, n, c) bfloat16 values as numpy f32, idx (k, n)): local
    neighbours with -1 slots, the rows 200 .. 219 named by no slot, row 5
    named by every query in plane 0."""
    rng = np.random.default_rng(seed)
    idx = np.clip(np.arange(n)[None, :] + rng.integers(-6, 7, size=(k, n)),
                  0, n - 1)
    idx = np.where((idx >= 200) & (idx < 220), idx - 20, idx)
    idx[rng.random((k, n)) < 0.1] = -1
    idx[0] = 5
    cot = torch.from_numpy(rng.normal(size=(k, n, c)).astype(
        np.float32) * np.exp(rng.normal(size=(k, n, c)).astype(np.float32)))
    return cot.to(torch.bfloat16).float().numpy(), idx.astype(np.int32)


@pytest.mark.parametrize("fill", [True, False])
def test_k4b_bf16_table_and_sum(fill):
    n, k, c = 256, 9, 24
    cot, idx = _k4b(31, n, k, c)
    d_out = torch.from_numpy(np.stack([cot, cot[::-1]]).copy()).to(
        torch.bfloat16)
    ti = torch.from_numpy(np.stack([idx, idx[:, ::-1]]).copy())
    off, slots = gather.inverse_table(ti, n, fill)
    counts = off[1:] - off[:-1]
    flat = ti.reshape(2, -1).long()
    keep = flat >= 0 if fill else torch.ones_like(flat, dtype=torch.bool)
    rows = (flat.clamp(min=0) + n * torch.arange(2)[:, None])[keep]
    assert torch.equal(counts, torch.bincount(rows, minlength=2 * n))
    assert counts[200:220].eq(0).all() and counts[5] >= n
    for r in range(2 * n):          # each segment: its row's slots, ascending
        seg = slots[off[r]:off[r + 1]]
        assert bool((seg[1:] > seg[:-1]).all())
        assert bool((ti.reshape(-1)[seg].clamp(min=0) + n * (seg // (k * n))
                     == r).all())
    got = gather.scatter_km_table(d_out, ti, n, fill)
    assert got.dtype == torch.bfloat16
    # ascending slot order is the plain version's: equal bit for bit
    assert torch.equal(got, gather.scatter_km_ref(d_out, ti, n, fill))
    assert torch.equal(got, gather.scatter_km_table(d_out, ti, n, fill))
    # against the Pallas gather's VJP (f32 sums in its own order, rounded
    # once): within one rounding, under 1% of the elements differing
    for b in range(2):
        idx_b = ti[b].numpy()
        jidx = jnp.asarray(idx_b)
        _, vjp = jax.vjp(lambda s: pallas_gather.gather_rows(
            s, jidx, interpret=True), jnp.zeros((n, c), jnp.bfloat16))
        jcot = d_out[b].float().numpy()
        if fill:       # the port's consumers read zeros at -1 slots
            jcot = np.where((idx_b >= 0)[..., None], jcot, 0.0)
        (jd,) = vjp(jnp.asarray(jcot, jnp.bfloat16))
        _hold_ulp(got[b].float(), np.asarray(jd.astype(jnp.float32)),
                  f"vjp sample {b}")
