"""K8-bf16's forward and K9 on the card, at the shapes their plans route
to the less common paths: the forward's taps a chunk at a time (a
262-wide xe into 96 at h 4) and its 128-slot tiles; K9's chains of one
block an SM (later layers 256 and 512 wide), a three-layer chain, and
one-layer sites at 16-byte and at single-column row loads; K9's
projection alone (``edge_mlp.projection``) at an input width that is not
a multiple of 8.  Each against its plain version (K8-bf16 at 2^-8 of the
largest value, K9 at phase 13's 1e-4, the projection at 1e-5 of
max(1, |plain|)), K9-bf16 equal to float32 K9 on the widened rows, two
runs bit-identical.
"""

import pytest
import torch

from curvecloudnet_tpu_torch.ops import conv1d_train as C
from curvecloudnet_tpu_torch.ops import edge_mlp as E

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_rel(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / float(
        want.abs().max().clamp(min=1e-30))


# (C_in, C_out, h, n_exp, used, bfloat16 xe): taps a chunk at a time on
# 128-slot tiles; an f32 input on 128-slot tiles; a 16-byte bfloat16 row
K8F_CARD = [(262, 96, 4, 3000, [2900, 1200], True),
            (96, 24, 3, 2500, [2500, 1234], False),
            (64, 32, 2, 2000, [2000, 999], True)]


@pytest.mark.parametrize("c_in,c_out,h,n_exp,used,bf16_in", K8F_CARD)
def test_k8f_kernel_paths(dev, c_in, c_out, h, n_exp, used, bf16_in):
    g = torch.Generator().manual_seed(5)
    z = torch.randn(2, n_exp, c_in, generator=g)
    bn = None
    if bf16_in:
        z = z.to(torch.bfloat16)
    else:
        bn = tuple(t.to(dev) for t in (0.3 * torch.randn(c_in, generator=g),
                                       0.5 + torch.rand(c_in, generator=g),
                                       1 + 0.2 * torch.randn(c_in, generator=g),
                                       0.1 * torch.randn(c_in, generator=g)))
    w = (torch.randn((h + 1) * c_in, c_out, generator=g)
         / ((h + 1) * c_in) ** 0.5).to(dev)
    b = (0.1 * torch.randn(c_out, generator=g)).to(dev)
    args = (z.to(dev), bn, w, b, torch.tensor(used, dtype=torch.int32,
                                              device=dev), h)
    n0 = C.conv1d_train_fwd_layer_bf16.launches
    got = C.conv1d_train_fwd_layer(*args, True)
    assert C.conv1d_train_fwd_layer_bf16.launches == n0 + 1
    want = C.conv1d_train_fwd_layer_ref(*args, True)
    for x, y in zip(got, want):
        assert _max_rel(x, y) <= 2.0 ** -8
    again = C.conv1d_train_fwd_layer(*args, True)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# (C, widths): chains of one block an SM (256 and 512 wide), a three-layer
# chain, one-layer sites at float4 and single-column loads
K9_CARD = [(64, (256, 256)), (37, (512, 96)), (67, (128, 128, 64)),
           (256, (512,)), (5, (7,))]


@pytest.mark.parametrize("c,widths", K9_CARD)
def test_k9_kernel_paths(dev, c, widths):
    g = torch.Generator().manual_seed(7)
    n, k = 900, 21
    x = torch.randn(2, n, c, generator=g).to(torch.bfloat16)
    idx = torch.randint(0, n, (2, n, k), generator=g, dtype=torch.int32)
    idx[torch.rand(2, n, k, generator=g) < 0.3] = -1
    idx[:, 850:] = -1
    dims = (2 * c,) + widths
    weights = tuple((torch.randn(a, b, generator=g) / a ** 0.5).to(dev)
                    for a, b in zip(dims[:-1], dims[1:]))
    biases = tuple((0.1 * torch.randn(b, generator=g)).to(dev)
                   for b in widths)
    args = (x.to(dev), idx.to(dev), weights, biases)
    got = E.fused_edge_mlp_max(*args)
    want = E.fused_edge_mlp_max_ref(*args)
    rest = want[want != -100.0]
    assert float((got - want).abs().max()) <= 1e-4 * max(
        1.0, float(rest.abs().max()))
    assert bool((got[:, 850:] == -100.0).all())
    assert torch.equal(got, E.fused_edge_mlp_max(args[0].float(), *args[1:]))
    assert torch.equal(got, E.fused_edge_mlp_max(*args))


@pytest.mark.parametrize("c,h0", [(67, 64), (131, 128), (5, 7)])
def test_k9_projection(dev, c, h0):
    g = torch.Generator().manual_seed(c)
    x = torch.randn(2, 300, c, generator=g).to(torch.bfloat16)
    weights = ((torch.randn(2 * c, h0, generator=g) / c ** 0.5).to(dev),)
    biases = ((0.1 * torch.randn(h0, generator=g)).to(dev),)
    got = E.projection(x.to(dev), weights, biases)
    wproj, bproj = E.layer0_projection(weights, biases)
    want = (x.double() @ wproj.cpu().double() + bproj.cpu().double()).float()
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    assert torch.equal(got, E.projection(x.to(dev).float(), weights, biases))
