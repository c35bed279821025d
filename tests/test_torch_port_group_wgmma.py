"""K2-bf16's host side on the CPU (``ops/group_reduce.py``): the weight
image ``pack_bf16`` lays out for the kernel's stages
(``csrc/group_wgmma.cuh``), the launch plan and its ints.

The image must give back every layer's W rounded to bfloat16 (the plain
version's ``round_to``), transposed, with zeros in the padding, both by
an un-swizzle in plain torch (``unpack``) and element by element at the
byte the kernel's descriptors read (the stage table's offset, the slab,
the row, the 32-byte swizzle).  The kernel itself runs on the card
(``tests/test_torch_port_cuda_bf16.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from curvecloudnet_tpu_torch.ops import _build
from curvecloudnet_tpu_torch.ops import group_reduce as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (chain [C1, layer widths...], local layers): ragged widths, a one-layer
# MLP's attend chain, a 1024-wide layer, shapenet-seg's sa-geo site
CHAINS = [([36, 20, 44], 2), ([128, 64, 128], 0), ([1024, 1024, 1024], 2),
          ([64, 128, 256, 512, 1024, 1024, 1024], 4)]


def _layers(chain, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.normal(size=(a, c)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=c).astype(np.float32)))
            for a, c in zip(chain[:-1], chain[1:])]


def unpack(img, dims):
    """The inverse of ``pack_bf16``'s image: each layer's stored
    (columns padded to whole passes, k to 16) transposed weights."""
    out, off = [], 0
    for layer, npad in enumerate(G._stored_cols(dims)):
        k16 = G._round(dims[layer], 16)
        wt = torch.empty(npad, k16, dtype=img.dtype)
        for p0, pw in G._passes(npad, dims):
            slabs = img[off:off + pw * k16].reshape(k16 // 16, pw, 2, 8)
            wt[p0:p0 + pw] = G._swizzle32(slabs, pw).transpose(0, 1).reshape(
                pw, k16)
            off += pw * k16
        out.append(wt)
    return out


def _stored(w, chain):
    """W rounded to bfloat16, transposed, padded to whole passes of the
    chain's columns and to 16 k."""
    cin, cout = w.shape
    out = torch.zeros(G._round(cout, 64 * G._ns(chain)), G._round(cin, 16))
    out[:cout, :cin] = G.round_to(w, torch.bfloat16).t()
    return out


@pytest.mark.parametrize("chain,n_local", CHAINS)
def test_pack_round_trips(chain, n_local):
    layers = _layers(chain)
    img, bias = G.pack_bf16(layers, "cpu")
    assert img.dtype == torch.bfloat16 and bias.dtype == torch.float32
    got = unpack(img, chain)
    for (w, b), wt in zip(layers, got):
        assert torch.equal(wt.float(), _stored(w, chain))
    # the biases, each zero-padded to its layer's stored columns
    plan = G.plan_bf16(chain, n_local, True, 25, 1, 1000, 132)
    for layer, (_, b) in enumerate(layers):
        o, n = plan["boff"][layer], plan["npad"][layer]
        assert torch.equal(bias[o:o + n], torch.nn.functional.pad(
            b, (0, n - b.numel())))
    assert bias.numel() == sum(plan["npad"])


@pytest.mark.parametrize("chain,n_local", CHAINS)
def test_pack_at_the_kernels_bytes(chain, n_local):
    """Element (k, n) of layer l at the byte the kernel reads it: its
    stage's offset, slab k // 16, row n - pass start (32 bytes a row),
    16-byte chunk (k % 16) // 8 swapped where bit 2 of the row is set."""
    layers = _layers(chain, seed=1)
    img = G.pack_bf16(layers, "cpu")[0].view(torch.int16)
    bits = [_stored(w, chain).to(torch.bfloat16).view(torch.int16)
            for w, _ in layers]
    rng = np.random.default_rng(2)
    seen = 0
    for layer, p0, pw, s0, ns, off, nbytes in G.stage_table(chain):
        assert nbytes == ns * pw * 32 and off % 1024 == 0
        for _ in range(8):
            kk = int(rng.integers(16 * ns))
            k, n = 16 * s0 + kk, p0 + int(rng.integers(pw))
            row = n - p0
            byte = (off + (kk // 16) * pw * 32 + row * 32
                    + (((kk % 16) // 8) ^ ((row >> 2) & 1)) * 16
                    + (kk % 8) * 2)
            assert img[byte // 2] == bits[layer][n, k]
            seen += 1
    assert seen and 2 * img.numel() == sum(t[-1] for t in
                                           G.stage_table(chain))


def test_plan_fields_match_the_kernels_struct():
    """GW_FIELDS / GW_ARRAYS name GwMeta's ints in the source's order."""
    src = open(os.path.join(REPO, "curvecloudnet_tpu_torch", "csrc",
                            "group_wgmma.cuh")).read()
    body = re.search(r"struct GwMeta \{(.*?)\};", src, re.S).group(1)
    names, arrays = [], []
    for decl in re.findall(r"int ([^;]+);", body):
        for part in decl.split(","):
            part = part.strip()
            m = re.match(r"(\w+)\[GW_MAXL( \+ 1)?\]", part)
            if m:
                arrays.append((m.group(1), G.GW_MAXL + bool(m.group(2))))
            else:
                names.append(part)
    assert tuple(names) == G.GW_FIELDS
    assert tuple(arrays) == G.GW_ARRAYS
    for name in ("ROWS", "TILE", "SUB", "MAXL", "MAXST", "META", "QBITS"):
        want = int(re.search(rf"#define GW_{name} (\d+)", src).group(1))
        assert getattr(G, f"GW_{name}") == want, name
    plan = G.plan_bf16([64, 64, 64], 2, False, 21, 1, 3000, 132)
    ints = G.plan_ints(plan)
    assert len(ints) == len(G.GW_FIELDS) + sum(n for _, n in G.GW_ARRAYS)
    assert ints[:len(G.GW_FIELDS)] == [plan[f] for f in G.GW_FIELDS]


@pytest.mark.parametrize("chain,n_local,attend,k", [
    ([64, 64, 64], 2, False, 21), ([1024, 1024, 1024], 2, False, 32),
    ([1024, 1024], 1, False, 21), ([512, 512, 512, 256, 512], 2, True, 32),
    ([64, 128, 256, 512, 1024, 1024, 1024], 4, True, 65),
    ([36, 20, 44], 2, False, 21), ([128, 64, 128], 0, True, 25)])
def test_plan_regions(chain, n_local, attend, k):
    """The plan's shared-memory regions in order, disjoint, 1024-aligned
    where wgmma and the bulk copies read them; the spill tiles take a
    layer's earlier passes; scratch for the f32 messages where attend (or
    a one-layer MLP) needs them."""
    p = G.plan_bf16(chain, n_local, attend, k, 1, 5000, 132)
    tiles = lambda c: -(-c // 64)  # noqa: E731
    assert p["x_bytes"] == G.GW_TILE * max(
        [tiles(G._round(chain[0], 16))] + [tiles(n) for n in p["npad"][:-1]])
    assert p["s_off"] == p["nslot"] * p["x_bytes"]
    staging = 2 * p["nstg"] * (2 if attend else 1)
    assert (p["agg_split"] >= staging if p["agg_split"] else
            p["w_off"] - p["s_off"] >= staging * G.GW_TILE)
    wide = [n for n in p["npad"][:-1] if n > G.GW_PASS]
    if wide:
        assert p["w_off"] - p["s_off"] >= G.GW_TILE * 8
    assert p["meta_off"] == p["w_off"] + p["nst"] * G.GW_STAGE
    assert p["q_off"] == p["meta_off"] + p["nslot"] * G.GW_META
    assert p["eq_off"] == p["q_off"] + G.GW_QBITS
    assert p["bar_off"] - p["eq_off"] >= 4 * -(-5000 // 132 // 32)
    assert p["smem"] == 1024 + p["bar_off"] + 8 * (2 * p["nslot"]
                                                   + 2 * p["nst"] + 8)
    assert p["smem"] <= _build.MAX_SMEM
    assert all(p[f] % 1024 == 0 for f in ("x_bytes", "s_off", "w_off"))
    stages = len(G.stage_table(chain))
    assert (p["resident"] and p["nst"] == stages) or (
        not p["resident"] and 2 <= p["nst"] <= G.GW_MAXST)
    assert p["ns"] == min(8, -(-G._round(max(chain[1:]), 32) // 64))
    assert all(n % (64 * p["ns"]) == 0 for n in p["npad"])
    assert p["msg_ld"] == p["npad"][n_local - 1] if n_local else True
    assert p["msg_floats"] == (p["nslot"] * 64 * p["msg_ld"]
                               if attend or n_local == 0 else 0)
    assert p["grid"] == 132


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="limits"):
        G.plan_bf16([64, 2048], 1, False, 21, 1, 100, 132)
    with pytest.raises(ValueError, match="limits"):
        G.plan_bf16([64, 64], 1, False, 129, 1, 100, 132)


def test_group_reduce_bf16_needs_a_cuda_bfloat16_h1():
    h1 = torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        G.group_reduce_bf16(h1, torch.ones(1, 8, 4, dtype=torch.bool),
                            (torch.ones(16), torch.zeros(16)),
                            [(torch.zeros(16, 8), torch.zeros(8))])
