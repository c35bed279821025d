"""K1's and K8's tensor-core design on the CPU (``ops/conv_tc.py``, the model
of ``csrc/conv_tc.cuh``, ``csrc/conv1d_chain.cu`` and
``csrc/conv1d_train.cu``), held against the plain versions and against the
Pallas kernels in interpret mode, same numpy inputs.

The model is the kernels' arithmetic: every window product a 3xTF32
product of the layer input and the stacked taps [W_0 | ... | W_h], shifted
and pair-summed on the (h+1) C_out-wide side; the backward multiplies the
windows of dz; rows by the tiles the wrappers pick, each with its halo;
the cross-block sums (forward statistics, dW, db) in the kernels' fixed
orders.

Cases: C_in 8, 262 and 5 (the flagship's step_0 and step_31 inputs, and a
ragged width), h 1 and 2, B 2, n_exp 300 (no multiple of any tile); the
live counts ``used`` at 0 and at a tile edge, or inside the first tile's
halo and at n_exp; the forward and t pass with and without a previous
layer's BatchNorm on load.

Tolerances:
* model against plain: elementwise within 1e-6 of the sum of the absolute
  terms (the same computation in float64 on absolute values; for the
  statistics, their first-order change under z's bound): 3xTF32 keeps each
  product to ~2^-21 relative and sums in f32, as the plain matmuls do in
  another order (1xTF32, hi x hi alone, misses this bound);
* model against Pallas interpret: the tolerances of
  tests/test_torch_port_kernels_ref.py (K1: 1e-4) and
  tests/test_torch_port_conv_train.py (forward z 3e-5, statistics 1e-5,
  t pass 2e-4);
* the shift identity, exactly: on small integers every float64 operation
  is exact, so the projected-then-shifted products equal the window
  products bit for bit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvecloudnet_tpu.ops import pallas_conv1d
from curvecloudnet_tpu_torch.ops import conv1d_chain, conv1d_train
from curvecloudnet_tpu_torch.ops import conv_tc as M
from curvecloudnet_tpu_torch.ops.curve1d import window_concat_nomask
from curvecloudnet_tpu_torch.ops.group_reduce import tf32_round

torch.set_num_threads(1)
CSRC = Path(conv1d_chain.__file__).resolve().parent.parent / "csrc"
N_EXP, B = 300, 2
C_INS = (8, 262, 5)
# h -> the chain's widths: (h+1) C_out is 96 on the main path, 32 / 48 at h 1
WIDTHS = {1: (16, 24), 2: (32, 32, 32)}
TILE_N = 128  # the Pallas kernels' tile in the JAX tests


def _used(case: str, tile: int):
    """The two samples' live counts: 0 and a tile edge, or a slot inside
    the first tile's halo and n_exp."""
    return torch.tensor([0, tile] if case == "edges" else [tile + 1, N_EXP],
                        dtype=torch.int32)


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _chain_inputs(c_in, h):
    rng = np.random.default_rng(c_in * 10 + h)
    xe = _f32(rng, B, N_EXP, c_in)
    weights, cin = [], c_in
    for cout in WIDTHS[h]:
        weights.append((_f32(rng, (h + 1) * cin, cout,
                             scale=((h + 1) * cin) ** -0.5),
                        _f32(rng, cout, scale=0.1)))
        cin = cout
    return xe, tuple(weights)


def _bn(rng, c):
    """(mean, inv, gamma, beta) of a BatchNorm."""
    return (_f32(rng, c, scale=0.2),
            torch.from_numpy((1 + 0.2 * rng.random(c)).astype(np.float32)),
            1 + _f32(rng, c, scale=0.2), _f32(rng, c, scale=0.1))


def _layer_inputs(c_in, h, prev_bn):
    """One train layer's inputs: z_prev (xe, or the previous pre-BN z with
    its BN), W, b, this layer's BN, d_u, c1, c2."""
    rng = np.random.default_rng(1000 + c_in * 10 + h + 5 * prev_bn)
    c_out = WIDTHS[h][0]
    z_prev = _f32(rng, B, N_EXP, c_in)
    bn_prev = _bn(rng, c_in) if prev_bn else None
    w = _f32(rng, (h + 1) * c_in, c_out, scale=((h + 1) * c_in) ** -0.5)
    b = _f32(rng, c_out, scale=0.1)
    z = _f32(rng, B, N_EXP, c_out)
    return dict(z_prev=z_prev, bn_prev=bn_prev, w=w, b=b, z=z,
                bn=_bn(rng, c_out), d_u=_f32(rng, B, N_EXP, c_out),
                c1=_f32(rng, c_out, scale=0.05),
                c2=_f32(rng, c_out, scale=0.05))


def _d(t):
    return t.double()


def _abs_layer(u, w, b, h):
    """Sum of |terms| of a layer's outputs: |window(u)| @ |W| + |b|."""
    return window_concat_nomask(_d(u).abs(), h) @ _d(w).abs() + _d(b).abs()


def _within(got, want, scale, rel=1e-6):
    err = (_d(got) - _d(want)).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= rel * scale).all()), float((err / scale).max())


# ---------------------------------------------------------------------------
# the shift identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("c_in", C_INS)
def test_shift_identity_exact_in_float64(c_in, h):
    rng = np.random.default_rng(c_in + h)
    ints = lambda *s: torch.from_numpy(  # noqa: E731
        rng.integers(-8, 9, size=s).astype(np.float64))
    c_out = WIDTHS[h][0]
    u, w, dz = ints(B, 97, c_in), ints((h + 1) * c_in, c_out), ints(B, 97, c_out)
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, h, h))  # noqa: E731
    # forward: window(u) W = shift_sum(u [W_0 | ... | W_h])
    assert torch.equal(window_concat_nomask(u, h) @ w,
                       M.shift_sum(pad(u) @ M.stacked_taps(w, h), h, c_out))
    # d_u_prev: the transposed window product of dz
    w_t = w.reshape(h + 1, c_in, c_out).transpose(1, 2).reshape(-1, c_in)
    p_t = pad(dz) @ M.stacked_taps(w_t, h)
    assert torch.equal(window_concat_nomask(dz, h) @ w_t,
                       M.shift_sum(p_t, h, c_in))
    assert torch.equal(M.windows(pad(dz), h), window_concat_nomask(dz, h))
    # dW: the shift moved from u to dz
    assert torch.equal(torch.einsum("bqi,bqo->io",
                                    window_concat_nomask(u, h), dz),
                       torch.einsum("bqi,bqd->id", u,
                                    M.windows(pad(dz), h))
                       .reshape(c_in, h + 1, c_out).transpose(0, 1)
                       .reshape(-1, c_out))


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["edges", "halo_end"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("c_in", C_INS)
def test_chain_model_matches_plain(c_in, h, case):
    xe, weights = _chain_inputs(c_in, h)
    used = _used(case, conv1d_chain.tile_rows(h, len(weights)))
    got = M.chain_eval_model(xe, weights, used, h)
    want = conv1d_chain.conv1d_chain_eval_ref(xe, weights, used, h)
    scale = xe
    for w, b in weights:
        scale = _abs_layer(scale, w, b, h)
    _within(got, want, scale)
    assert bool(got[1].any())
    if case == "edges":
        assert not bool(got[0].any())  # sample 0 has no live slot


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("c_in", C_INS)
def test_chain_model_matches_pallas(c_in, h):
    xe, weights = _chain_inputs(c_in, h)
    used = _used("halo_end", conv1d_chain.tile_rows(h, len(weights)))
    got = M.chain_eval_model(xe, weights, used, h)
    for bi in range(B):
        want = pallas_conv1d.conv1d_chain_eval(
            jnp.asarray(xe[bi].numpy()),
            tuple((jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
                  for w, b in weights),
            int(used[bi]), half_k=h, tile_n=TILE_N, interpret=True)
        np.testing.assert_allclose(got[bi].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K8's forward
# ---------------------------------------------------------------------------


def _xe_zero_past_used(s, used):
    """Layer 1's input is xe, zero past ``used`` (the Pallas kernels mask
    it, the port's callers build it so)."""
    if s["bn_prev"] is None:
        for bi in range(B):
            s["z_prev"][bi, int(used[bi]):] = 0.0


def _fwd_args(s, used, h):
    return (s["z_prev"], s["bn_prev"], s["w"], s["b"], used, h)


@pytest.mark.parametrize("prev_bn", [False, True])
@pytest.mark.parametrize("case", ["edges", "halo_end"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("c_in", C_INS)
def test_fwd_model_matches_plain(c_in, h, case, prev_bn):
    s = _layer_inputs(c_in, h, prev_bn)
    used = _used(case, conv1d_train.fwd_tile(h))
    args = _fwd_args(s, used, h)
    z, mean, var = M.fwd_model(*args)
    r_z, r_mean, r_var = conv1d_train.conv1d_train_fwd_layer_ref(*args)
    live = conv1d_train._live(used, N_EXP, "cpu").double()
    u = conv1d_train._u_of(s["z_prev"], s["bn_prev"], live.float())
    z_scale = _abs_layer(u, s["w"], s["b"], h)
    _within(z, r_z, z_scale)
    n = float(used.sum())
    _within(mean, r_mean, (z_scale * live).sum((0, 1)) / n)
    dev = (_d(r_z) - _d(r_mean)).abs()
    _within(var, r_var, 2 * (z_scale * dev * live).sum((0, 1)) / n)


def test_fwd_model_needs_three_products():
    """1xTF32 (hi x hi alone) misses the 1e-6 bound on the wide layer."""
    s = _layer_inputs(262, 2, False)
    used = _used("halo_end", conv1d_train.fwd_tile(2))
    args = _fwd_args(s, used, 2)
    want = conv1d_train.conv1d_train_fwd_layer_ref(*args)[0]
    scale = _abs_layer(s["z_prev"], s["w"], s["b"], 2)
    one = lambda a, b: tf32_round(a.contiguous()) @ tf32_round(  # noqa: E731
        b.contiguous())
    orig = M.mm3
    try:
        M.mm3 = one
        got = M.fwd_model(*args)[0]
    finally:
        M.mm3 = orig
    assert float(((_d(got) - _d(want)).abs() / scale).max()) > 1e-6


@pytest.mark.parametrize("prev_bn", [False, True])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("c_in", C_INS)
def test_fwd_model_matches_pallas(c_in, h, prev_bn):
    s = _layer_inputs(c_in, h, prev_bn)
    used = _used("halo_end", conv1d_train.fwd_tile(h))
    _xe_zero_past_used(s, used)
    z, mean, var = M.fwd_model(*_fwd_args(s, used, h))
    bn_prev = (None if s["bn_prev"] is None
               else tuple(jnp.asarray(t.numpy()) for t in s["bn_prev"]))
    outs = [pallas_conv1d._run_fwd_layer(
        jnp.asarray(s["z_prev"][bi].numpy()), bn_prev,
        jnp.asarray(s["w"].numpy()), jnp.asarray(s["b"].numpy()),
        int(used[bi]), TILE_N, h, True, jnp.float32) for bi in range(B)]
    j_mean, j_var = pallas_conv1d._finalize_stats(
        sum(o[1] for o in outs), sum(o[2] for o in outs), float(used.sum()))
    np.testing.assert_allclose(
        z.numpy(), np.stack([np.asarray(o[0]) for o in outs]), rtol=3e-5,
        atol=3e-5)
    np.testing.assert_allclose(mean.numpy(), j_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), j_var, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K8's t pass
# ---------------------------------------------------------------------------


def _t_args(s, used, h):
    return (s["d_u"], s["z"], s["z_prev"], s["bn"], s["bn_prev"], s["w"],
            s["c1"], s["c2"], used, h)


@pytest.mark.parametrize("prev_bn", [False, True])
@pytest.mark.parametrize("case", ["edges", "halo_end"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("c_in", C_INS)
def test_t_model_matches_plain(c_in, h, case, prev_bn):
    s = _layer_inputs(c_in, h, prev_bn)
    # the dW splits' edges: a multiple of 32 slots
    rps = conv1d_train.dw_splits(N_EXP, c_in, B)[1]
    used = _used(case, rps if case == "edges" else M.ROWS)
    args = _t_args(s, used, h)
    got = M.t_model(*args)
    want = conv1d_train.conv1d_train_bwd_t_ref(*args)
    live = conv1d_train._live(used, N_EXP, "cpu")
    _, inv, gam, _ = s["bn"]
    xhat, y = conv1d_train._affine(s["z"], s["bn"])
    dz = _d(inv) * (_d(s["d_u"] * live * conv1d_train._dleaky(y) * gam)
                    - _d(live) * (_d(s["c1"]) + _d(xhat) * _d(s["c2"])))
    w_t = s["w"].reshape(h + 1, c_in, -1).transpose(1, 2).reshape(-1, c_in)
    u = conv1d_train._u_of(s["z_prev"], s["bn_prev"], live)
    scales = (window_concat_nomask(dz.abs(), h) @ _d(w_t).abs(),
              torch.einsum("bqi,bqo->io",
                           window_concat_nomask(_d(u).abs(), h), dz.abs()),
              dz.abs().sum((0, 1)))
    for g, w_, sc in zip(got, want, scales):
        _within(g, w_, sc)
    if case == "edges":
        assert not bool(got[0][0].any())  # sample 0: dz = 0 everywhere


@pytest.mark.parametrize("prev_bn", [False, True])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("c_in", C_INS)
def test_t_model_matches_pallas(c_in, h, prev_bn):
    s = _layer_inputs(c_in, h, prev_bn)
    used = _used("halo_end", M.ROWS)
    _xe_zero_past_used(s, used)
    got = M.t_model(*_t_args(s, used, h))
    j = lambda t: None if t is None else tuple(  # noqa: E731
        jnp.asarray(a.numpy()) for a in t)
    outs = [pallas_conv1d._run_bwd_t(
        jnp.asarray(s["d_u"][bi].numpy()), jnp.asarray(s["z"][bi].numpy()),
        jnp.asarray(s["z_prev"][bi].numpy()), j(s["bn"]), j(s["bn_prev"]),
        jnp.asarray(s["w"].numpy()), jnp.asarray(s["c1"].numpy()),
        jnp.asarray(s["c2"].numpy()), int(used[bi]), TILE_N, h, True,
        jnp.float32) for bi in range(B)]
    want = (np.stack([np.asarray(o[0]) for o in outs]),
            sum(np.asarray(o[1]) for o in outs),
            sum(np.asarray(o[2]) for o in outs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# K8-bf16's t pass: its order of partial sums
# ---------------------------------------------------------------------------


def _bf16_scales(s, used, h):
    """Sums of |terms| of the bfloat16 t pass's outputs: the rounded pairs
    times the rounded weights (d_u_prev), the rounded pairs of u times the
    rounded dz (dW), |dz| (db); float64."""
    live = conv1d_train._live(used, N_EXP, "cpu")
    _, inv, gam, _ = s["bn"]
    xhat, y = conv1d_train._affine(s["z"], s["bn"])
    dz = inv * (s["d_u"] * live * conv1d_train._dleaky(y) * gam
                - live * (s["c1"] + xhat * s["c2"]))
    c_in = s["z_prev"].shape[-1]
    w_t = s["w"].reshape(h + 1, c_in, -1).transpose(1, 2).reshape(-1, c_in)
    rb = lambda t: _d(t.to(torch.bfloat16).float()).abs()  # noqa: E731
    u = conv1d_train._u_of(s["z_prev"].float(), s["bn_prev"], live)
    return (window_concat_nomask(rb(dz), h) @ rb(w_t),
            torch.einsum("bqi,bqo->io", window_concat_nomask(rb(u), h),
                         rb(dz)),
            _d(dz).abs().sum((0, 1)))


@pytest.mark.parametrize("prev_bn", [False, True])
@pytest.mark.parametrize("case", ["edges", "halo_end"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("c_in", C_INS)
def test_t_model_bf16_matches_plain(c_in, h, case, prev_bn):
    """The bfloat16 t pass's order of partial sums (a tile's partial for
    inputs up to DW_FUSED wide, with the previous layer's reduce sums;
    every tap of a split's stages for wider ones) against the plain
    version: the products are exact in float32, so only the order of the
    float32 sums differs: within 1e-6 of the sum of |terms|."""
    s = _layer_inputs(c_in, h, prev_bn)
    rps = conv1d_train.dw_splits(N_EXP, c_in, B, bf16=True, half_k=h)[1]
    used = _used(case, rps)
    sums = prev_bn and conv1d_train.fused_reduce(c_in)
    args = _t_args(s, used, h)
    got = M.t_model_bf16(*args, prev_sums=sums)
    want = conv1d_train.conv1d_train_bwd_t_ref(*args, prev_sums=sums,
                                               bf16=True)
    for g, w_, sc in zip(got, want, _bf16_scales(s, used, h)):
        _within(g, w_, sc)
    if sums:  # the reduce sums over d_u_prev: 1e-6 of the sum of |terms|
        live = conv1d_train._live(used, N_EXP, "cpu").double()
        xhat, y = conv1d_train._affine(_d(s["z_prev"]), tuple(
            _d(t) for t in s["bn_prev"]))
        da = (_d(want[0]) * conv1d_train._dleaky(y) * live).abs()
        dxh = da * _d(s["bn_prev"][2]).abs()
        for g, w_, sc in zip(got[3], want[3], (dxh, dxh * xhat.abs(), da,
                                               da * xhat.abs())):
            _within(g, w_, sc.sum((0, 1)))
    if case == "edges":
        assert not bool(got[0][0].any())  # sample 0: dz = 0 everywhere


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("c_in", C_INS)
def test_t_model_bf16_matches_pallas(c_in, h):
    """On a bfloat16 xe (layer 1), against ``_run_bwd_t`` with cdt bfloat16
    in interpret mode: within 2^-8 of each output's largest value (one
    bfloat16 rounding: the Pallas kernel forms dz in another operation
    order, so a dz near a rounding boundary may round the other way)."""
    s = _layer_inputs(c_in, h, False)
    s["z_prev"] = s["z_prev"].to(torch.bfloat16)
    used = _used("halo_end", M.ROWS)
    _xe_zero_past_used(s, used)
    got = M.t_model_bf16(*_t_args(s, used, h))
    outs = [pallas_conv1d._run_bwd_t(
        jnp.asarray(s["d_u"][bi].numpy()), jnp.asarray(s["z"][bi].numpy()),
        jnp.asarray(s["z_prev"][bi].float().numpy()).astype(jnp.bfloat16),
        tuple(jnp.asarray(a.numpy()) for a in s["bn"]), None,
        jnp.asarray(s["w"].numpy()), jnp.asarray(s["c1"].numpy()),
        jnp.asarray(s["c2"].numpy()), int(used[bi]), TILE_N, h, True,
        jnp.bfloat16) for bi in range(B)]
    want = (np.stack([np.asarray(o[0], np.float32) for o in outs]),
            sum(np.asarray(o[1]) for o in outs),
            sum(np.asarray(o[2]) for o in outs))
    for g, w in zip(got, want):
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 2.0 ** -8 * float(np.abs(w).max()), err


# ---------------------------------------------------------------------------
# the launch shapes
# ---------------------------------------------------------------------------


def _define(name: str, src: str) -> int:
    m = re.search(rf"#define {name} (\d+)", (CSRC / src).read_text())
    return int(m.group(1))


def test_tiles_match_the_sources():
    assert conv1d_chain.ROWS == _define("CV_ROWS", "conv_tc.cuh")
    assert conv1d_train.DW_STAGE == _define("TDW_ROWS", "conv1d_train.cu")
    assert conv1d_train.DW_M == _define("TDW_M", "conv1d_train.cu")
    assert conv1d_train.DW_FUSED == _define("TDF_MAX", "conv1d_train.cu")
    assert conv1d_train.DW_STAGE_BF16 == _define("TBW_ROWS",
                                                 "conv1d_train.cu")
    assert conv1d_train.DW_M_BF16 == _define("TBW_M", "conv1d_train.cu")
    assert conv1d_train.TB_MAX_H == _define("TB_PAD", "conv1d_train.cu")
    assert conv1d_chain.tile_rows(2, 3) == 116
    assert conv1d_train.fwd_tile(2) == 124
    with pytest.raises(ValueError):
        conv1d_chain.tile_rows(16, 4)


@pytest.mark.parametrize("n_exp,c_in,bsz", [(49164, 262, 1), (49164, 32, 1),
                                            (143372, 8, 1), (300, 5, 2),
                                            (31, 64, 3), (1, 65, 1),
                                            (49164, 33, 2)])
def test_dw_splits_cover_the_rows(n_exp, c_in, bsz):
    splits, rps = conv1d_train.dw_splits(n_exp, c_in, bsz)
    assert rps % conv1d_train.DW_STAGE == 0 and rps > 0
    assert (splits - 1) * rps < n_exp <= splits * rps
    if c_in <= conv1d_train.DW_FUSED:  # a d_u_prev tile a split
        assert rps == M.ROWS
    else:
        blocks = -(-c_in // conv1d_train.DW_M) * splits * bsz
        assert blocks <= 2 * conv1d_train.DW_BLOCKS
    # bfloat16: a d_u_prev tile of ROWS - 2h slots a split up to DW_FUSED
    # wide (the fused kernel), else stages of DW_STAGE_BF16 over m-chunks
    # of DW_M_BF16 channels
    for h in (1, 2, 3):
        splits, rps = conv1d_train.dw_splits(n_exp, c_in, bsz, bf16=True,
                                             half_k=h)
        assert (splits - 1) * rps < n_exp <= splits * rps
        if c_in <= conv1d_train.DW_FUSED:
            assert rps == conv1d_train.fwd_tile(h) == M.ROWS - 2 * h
        else:
            assert rps % conv1d_train.DW_STAGE_BF16 == 0 and rps > 0
            blocks = -(-c_in // conv1d_train.DW_M_BF16) * splits * bsz
            assert blocks <= 2 * conv1d_train.DW_BLOCKS
