"""K8-bf16's forward and K9 as designed for the H100, modelled on the CPU.

K8-bf16's forward (``csrc/conv1d_train.cu``): the launch plan
(``conv1d_train.plan_fwd_bf16``: the fields of ``struct FbPlan`` in order,
256-slot tiles with the taps resident where they fit), the taps image its
pack kernel writes (``conv_tc.pack_fwd_bf16``) and its schedule
(``conv_tc.fwd_model_bf16``: u rounded once, the pairs rounded in
bfloat16, the products chunk by chunk, z, the moments of 16-row groups
combined in a fixed order) against the plain version
(``conv1d_train_fwd_layer_ref(bf16=True)``) and the Pallas kernel in
interpret mode (``pallas_conv1d._run_fwd_layer`` with a bfloat16 compute
dtype) on the same numpy-seeded input: z within 2^-8 of its largest
value, the mean and variance within one bfloat16 rounding of theirs.
``fwd_tile`` still sizes the float32 forward and the bfloat16 t pass.

K9 (``csrc/edge_mlp.cu``): the projection with the x_lo product left out
(``edge_mlp.projection_model(lo=False)``, K9-bf16) equals the 3-product
form bit for bit on bfloat16-valued x; the whole schedule
(``edge_mlp.edge_model``: the projection, then K2's live-row chain in
chunks, its later layers 3xTF32 products) on a bfloat16 x against
``fused_edge_mlp_max_ref`` (1e-5 of max(1, |plain|)) and
``pallas_edge.fused_edge_mlp_max_single(interpret=True)`` (the JAX test's
2e-4), with dead slots, padding queries and the slow-order fold; the plan
(``edge_mlp.plan``: the fields of ``struct EmPlan`` in order, the image's
regions, the chain's launch shape).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvecloudnet_tpu.ops import pallas_conv1d, pallas_edge
from curvecloudnet_tpu_torch.models.layers import MLP
from curvecloudnet_tpu_torch.ops import _build, conv1d_chain
from curvecloudnet_tpu_torch.ops import conv1d_train as C
from curvecloudnet_tpu_torch.ops import conv_tc
from curvecloudnet_tpu_torch.ops import edge_mlp as E

torch.set_num_threads(1)
BF16_REL = 2.0 ** -8   # one bfloat16 rounding at a quantity's scale


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# K8-bf16's forward
# ---------------------------------------------------------------------------


def _layer(seed, c_in, c_out, h, n_exp, used, bf16_in, b=2):
    """(z_prev, bn_prev, w, b, used) from numpy: a bfloat16 xe (zero past
    each sample's used slots) without a BN, or an f32 z with a BN
    (mean, inv, gamma, beta)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, n_exp, c_in)).astype(np.float32)
    bn = None
    if bf16_in:
        for i, u in enumerate(used):
            z[i, u:] = 0.0
    else:
        z = 2.0 * z + 0.5
        bn = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
            rng.normal(size=c_in) * 0.3 + 0.5, 0.5 + rng.random(c_in),
            1.0 + 0.2 * rng.normal(size=c_in), 0.1 * rng.normal(size=c_in)))
    zt = torch.from_numpy(z)
    if bf16_in:
        zt = zt.to(torch.bfloat16)
    w = rng.normal(size=((h + 1) * c_in, c_out)) / np.sqrt((h + 1) * c_in)
    bias = 0.1 * rng.normal(size=c_out)
    return (zt, bn, torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy(bias.astype(np.float32)),
            torch.tensor(used, dtype=torch.int32))


# (C_in, C_out, h, n_exp, used, bfloat16 xe): step_31's layer 1 with its
# 262-wide xe scaled to 22 (not a multiple of 8) over three 252-slot
# tiles, ``used`` cutting the second; a later layer (f32 z, a previous
# BN); an input of two 64-column chunks at one tap a side; a sample with
# no live slot
K8F_CASES = [(22, 32, 2, 600, [590, 300], True),
             (32, 32, 2, 600, [600, 251], False),
             (70, 24, 1, 300, [300, 0], True),
             (24, 16, 3, 260, [259, 100], False)]


@pytest.mark.parametrize("c_in,c_out,h,n_exp,used,bf16_in", K8F_CASES)
def test_k8f_model_matches_plain_and_pallas(c_in, c_out, h, n_exp, used,
                                            bf16_in):
    z_prev, bn, w, b, tu = _layer(c_in + h, c_in, c_out, h, n_exp, used,
                                  bf16_in)
    with torch.no_grad():
        z, mean, var = conv_tc.fwd_model_bf16(z_prev, bn, w, b, tu, h)
        rz, rmean, rvar = C.conv1d_train_fwd_layer_ref(z_prev, bn, w, b, tu,
                                                       h, True)
    assert z.dtype == torch.float32 and z.shape == rz.shape
    assert _max_rel(z, rz) <= BF16_REL
    assert _max_rel(mean, rmean) <= BF16_REL
    assert _max_rel(var, rvar) <= BF16_REL
    # the Pallas kernel in interpret mode, a sample at a time, with the
    # JAX package's bfloat16 compute dtype
    jz = z_prev.float().numpy() if not bf16_in else None
    jbn = None if bn is None else tuple(jnp.asarray(t.numpy()) for t in bn)
    outs = []
    for bi in range(2):
        x = (jnp.asarray(z_prev[bi].float().numpy()).astype(jnp.bfloat16)
             if bf16_in else jnp.asarray(jz[bi]))
        outs.append(pallas_conv1d._run_fwd_layer(
            x, jbn, jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
            int(used[bi]), 128, h, True, jnp.bfloat16))
    j_mean, j_var = pallas_conv1d._finalize_stats(
        sum(o[1] for o in outs), sum(o[2] for o in outs),
        max(sum(used), 1))
    jzs = np.stack([np.asarray(o[0]) for o in outs])
    assert _max_rel(z, jzs) <= BF16_REL
    assert _max_rel(mean, np.asarray(j_mean)) <= BF16_REL
    assert _max_rel(var, np.asarray(j_var)) <= BF16_REL


def test_fwd_tile_still_sizes_the_f32_forward_and_the_t_pass():
    """``fwd_tile`` is the 128-slot block less its halo (the float32
    forward's tiles and the bfloat16 t pass's fused dW tiles); the
    bfloat16 forward's tile is its plan's rows less the halo."""
    for h in (1, 2, 3):
        assert C.fwd_tile(h) == conv1d_chain.ROWS - 2 * h
        assert C.dw_splits(1000, 32, 1, bf16=True, half_k=h) == (
            -(-1000 // C.fwd_tile(h)), C.fwd_tile(h))
        assert C.dw_splits(1000, 32, 1) == (-(-1000 // 128), 128)
    assert C.fwd_tile_bf16(262, 32, 2) == 252
    assert C.fwd_tile_bf16(32, 32, 2, bf16_in=False) == 252


def _struct_fields(src: str, name: str):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        names = decl.split(None, 1)[1]
        for part in names.split(","):
            m = re.match(r"\s*(\w+)(?:\[([^\]]+)\])?", part)
            fields.append((m.group(1), m.group(2)))
    return fields


def test_fwd_plan_is_the_c_struct():
    """``FB_FIELDS`` are ``struct FbPlan``'s ints in order; the ring's
    constants are the kernel's."""
    src = (_build.CSRC / "conv1d_train.cu").read_text()
    assert [f for f, _ in _struct_fields(src, "FbPlan")] == list(C.FB_FIELDS)
    assert f"#define FB_MAX_STAGES {C.FB_MAX_STAGES}" in src
    assert "#define FB_LDF (CB_KC + 4)" in src
    tc = (_build.CSRC / "conv_tc.cuh").read_text()
    assert f"#define CB_KC {conv1d_chain.CHUNK_BF16}" in tc
    assert C.FB_LDK == conv1d_chain.CHUNK_BF16 + 8


# (C_in, C_out, h, bfloat16 in, rows, resident): the main path's three
# layers; the card tests' shapes; a 262-wide input into 96 at h 4, whose
# taps do not fit (a chunk's at a time)
FB_PLANS = [(262, 32, 2, True, 256, 1), (32, 32, 2, False, 256, 1),
            (40, 64, 1, True, 256, 1), (64, 48, 1, False, 128, 1),
            (16, 96, 3, True, 256, 1), (96, 24, 3, False, 128, 1),
            (262, 96, 4, True, 128, 0)]


@pytest.mark.parametrize("c_in,c_out,h,bf16_in,rows,resident", FB_PLANS)
def test_fwd_plan_lays_out_shared_memory(c_in, c_out, h, bf16_in, rows,
                                         resident):
    p = C.plan_fwd_bf16(c_in, c_out, h, bf16_in)
    assert (p["rows"], p["resident"]) == (rows, resident)
    assert p["kp"] == -(-c_in // 16) * 8 and p["ldn"] % 4 == 0
    assert p["bias_off"] == (h + 1) * p["kp"] * p["ldn"]
    chunk = (h + 1) * (conv1d_chain.CHUNK_BF16 // 2) * p["ldn"]
    assert p["taps_words"] == (p["bias_off"] if resident else chunk)
    offs = [4 * p["taps_words"]] + [p[k] for k in (
        "ring_off", "a_off", "z_off", "bn_off", "mom_off", "smem")]
    assert offs == sorted(offs)
    assert all(p[k] % 16 == 0 for k in ("ring_off", "a_off", "z_off",
                                         "bn_off", "mom_off"))
    ring = rows * (2 * C.FB_LDK if bf16_in else 4 * C.FB_LDF)
    assert p["a_off"] - p["ring_off"] >= p["stages"] * ring
    assert p["bn_off"] - p["z_off"] >= 4 * (rows - 2 * h) * p["ldz"]
    assert p["smem"] - p["mom_off"] >= 8 * (rows // 16) * c_out
    assert 2 <= p["stages"] <= C.FB_MAX_STAGES
    assert p["smem"] <= _build.MAX_SMEM


def test_fwd_image_holds_the_rounded_taps():
    """The image's words are the bfloat16 taps in pairs of rows, then the
    f32 bias, 0 past C_in and C_out."""
    _, _, w, b, _ = _layer(3, 22, 20, 2, 10, [10, 10], True)
    p = C.plan_fwd_bf16(22, 20, 2, True)
    img = conv_tc.pack_fwd_bf16(w, b, 2, p)
    words = img[:p["bias_off"]].reshape(3, p["kp"], p["ldn"])
    lo = ((words & 0xFFFF) << 16).view(torch.float32)
    hi = (words & -0x10000).view(torch.float32)
    taps = torch.stack([lo, hi], 2).reshape(3, 2 * p["kp"], p["ldn"])
    want = w.to(torch.bfloat16).float().reshape(3, 22, 20)
    assert torch.equal(taps[:, :22, :20], want)
    assert not bool(taps[:, 22:].any()) and not bool(taps[..., 20:].any())
    assert torch.equal(img[p["bias_off"]:p["bias_off"] + 20].view(
        torch.float32), b)


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


def _edge_case(c, widths, n, k, seed, slow=False):
    """(x bfloat16-valued (B=2), nbr with dead slots and padding queries,
    the folded weights of an eval MLP with random BN statistics)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, n, c)).astype(
        np.float32)).to(torch.bfloat16)
    nbr = rng.integers(0, n, size=(2, n, k)).astype(np.int32)
    nbr[:, :, 0] = np.arange(n)
    nbr[rng.random((2, n, k)) < 0.3] = -1
    nbr[:, n - 7:] = -1                       # padding queries
    g = torch.Generator().manual_seed(seed)
    mlp = MLP((2 * c,) + widths, use_bias=True).eval()
    with torch.no_grad():
        for lin in mlp.lins:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g)
                             / lin.weight.shape[1] ** 0.5)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g))
        for nrm in mlp.norms:
            nrm.running_var.copy_(0.2 + torch.rand(nrm.running_var.shape,
                                                   generator=g))
            nrm.running_mean.copy_(torch.randn(nrm.running_mean.shape,
                                               generator=g))
        weights, biases = E.fold_edge_mlp_eval(mlp, slow=slow)
    return x, torch.from_numpy(nbr), weights, biases


@pytest.mark.parametrize("c,widths", [(67, (64, 64)), (13, (16,)),
                                      (131, (24, 16, 8))])
def test_k9_bf16_projection_leaves_out_the_zero_product(c, widths):
    """x_lo of a bfloat16 value is 0: the projection without its product
    (K9-bf16) equals the 3-product form (float32 K9 on the widened rows)
    bit for bit; on an f32 x the product is not 0."""
    x, _, weights, biases = _edge_case(c, widths, 50, 4, c)
    with torch.no_grad():
        two = E.projection_model(x, weights, biases, lo=False)
        three = E.projection_model(x.float(), weights, biases, lo=True)
        assert torch.equal(two, three)
        x32 = x.float() + 1e-3 * torch.randn(x.shape)
        assert not torch.equal(E.projection_model(x32, weights, biases, False),
                               E.projection_model(x32, weights, biases, True))


# (C, widths, slow): one-layer sites (the flagship's step 6 shape
# narrowed, an odd width), a two-layer site (step 3's narrowed), three
# layers; the slow message order folded into W_0
K9_BF16_CASES = [(11, (16,), False), (5, (7,), True), (19, (16, 16), False),
                 (19, (16, 16), True), (9, (24, 16, 8), False)]


@pytest.mark.parametrize("c,widths,slow", K9_BF16_CASES)
def test_k9_bf16_model_matches_plain_and_pallas(c, widths, slow):
    n, k = 160, 9
    x, nbr, weights, biases = _edge_case(c, widths, n, k, 3 * c, slow)
    with torch.no_grad():
        got, straddled = E.edge_model(x, nbr, weights, biases)
        want = E.fused_edge_mlp_max_ref(x, nbr, weights, biases)
    assert straddled > 0               # queries straddle two chunks
    rest = want[want != -100.0]
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(rest.abs().max())), err
    assert bool((got[:, n - 7:] == -100.0).all())
    xs = x.float().numpy()
    nb = nbr.numpy()
    jw = tuple(jnp.asarray(w.detach().numpy()) for w in weights)
    jb = tuple(jnp.asarray(b.detach().numpy()) for b in biases)
    jax_out = np.stack([np.asarray(pallas_edge.fused_edge_mlp_max_single(
        jnp.asarray(xs[bi][np.maximum(nb[bi], 0)]), jnp.asarray(xs[bi]),
        jnp.asarray(nb[bi] >= 0), jw, jb, interpret=True))
        for bi in range(2)])
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=2e-4, atol=2e-4)


def test_k9_plan_is_the_c_struct():
    """``PLAN_FIELDS`` are ``struct EmPlan``'s fields in order, arrays at
    their lengths; the tile constants are the kernel's."""
    src = (_build.CSRC / "edge_mlp.cu").read_text()
    sizes = {"EM_MAX_LAYERS": E.MAX_LAYERS,
             "EM_MAX_LAYERS + 1": E.MAX_LAYERS + 1}
    got = [(f, sizes[n] if n else 1) for f, n in _struct_fields(src,
                                                                 "EmPlan")]
    assert got == list(E.PLAN_FIELDS)
    assert f"#define EM_MAX_LAYERS {E.MAX_LAYERS}" in src


@pytest.mark.parametrize("c,dims", [(67, (134, 64, 64)), (131, (262, 128)),
                                    (9, (18, 24, 16, 8))])
def test_k9_plan_lays_out_the_image(c, dims):
    """The image's regions follow one another without overlap: the
    projection's hi and lo tiles, its bias, then each later layer's f32 W
    from a 16-byte boundary, then their biases (``pack_layers``' layout);
    the chain's launch shape is ``_chain_shape``'s."""
    p = E.plan(c, dims, 21, 5000, 1, 132)
    tile = p["c8"] * E._PROJ_COLS
    assert p["ntile"] == -(-2 * dims[1] // E._PROJ_COLS)
    assert (p["p_lo"], p["p_b"]) == (p["ntile"] * tile, 2 * p["ntile"] * tile)
    at = p["w_first"]
    assert at == p["p_b"] + p["ntile"] * E._PROJ_COLS
    for l in range(1, len(dims) - 1):
        assert p["woff"][l] == at and at % 4 == 0
        at += -(-dims[l] * dims[l + 1] // 4) * 4
    for l in range(1, len(dims) - 1):
        assert p["boff"][l] == at
        at += dims[l + 1]
    assert p["total"] == -(-at // 4) * 4
    assert (p["rows"], p["tq"], p["ck"], p["per_sm"]) == E._chain_shape(
        dims[1:], 21, 5000, 132)
    assert len(E._plan_ints(c, dims, 21, 5000, 1, 132)) == sum(
        n for _, n in E.PLAN_FIELDS)
