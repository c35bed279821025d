"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a GPU.  On a
machine with one (and nvcc), run::

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerances: K1/K2 sum f32 products in another order than the plain
matmuls, 1e-4 relative to the output scale; K3 distances and K6 picks use
round-to-nearest arithmetic in the plain versions' order, so they match
exactly (indices may differ only between slots of equal distance).  K7:
forward outputs and batch statistics 1e-4 relative to their scale;
gradients in relative L2 norm within 1e-3 plus 3x the plain version's own
change when h1 is perturbed by 1e-5 relative (norms floored at 1e-3 of
the call's largest, for tensors that are zero in exact arithmetic): the
activation's derivative jumps at 0 (1 vs 0.01) and a max picks one of two
near-equal slots, so rare rows within rounding of such a point take
another branch in the kernel than in the plain version, moving single
elements by up to their own size.  K4 copies rows (exact);
K4b adds with atomics (1e-5).  The whole train step is held to the CPU
plain path against a yardstick: the plain path's own change under a 1e-5
relative weight perturbation (train-mode BatchNorm over 33 steps amplifies
rounding-sized differences).
"""

import numpy as np
import pytest
import torch

from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.ops import (conv1d_chain, fps, gather,
                                         group_reduce, group_train, knn)
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


@pytest.mark.parametrize("c0,dims,h", [(8, (32, 32, 32), 2),
                                       (262, (32, 32, 32), 2),
                                       (5, (16, 24), 1)])
def test_conv1d_chain_kernel(dev, c0, dims, h):
    g = torch.Generator().manual_seed(0)
    n_exp = 3000
    xe = torch.randn(2, n_exp, c0, generator=g)
    weights, cin = [], c0
    for cout in dims:
        weights.append((0.1 * torch.randn((h + 1) * cin, cout, generator=g),
                        0.1 * torch.randn(cout, generator=g)))
        cin = cout
    used = torch.tensor([2900, 1700], dtype=torch.int32)
    args = (xe.to(dev), tuple((w.to(dev), b.to(dev)) for w, b in weights),
            used.to(dev), h)
    got = conv1d_chain.conv1d_chain_eval(*args)
    assert _rel_err(got, conv1d_chain.conv1d_chain_eval_ref(*args)) <= 1e-4


@pytest.mark.parametrize("aggr,k,widths", [("max", 21, (64, 64, 64)),
                                           ("attend", 25, (64, 128, 192, 256)),
                                           ("max", 32, (1024, 1024, 1024))])
def test_group_reduce_kernel(dev, aggr, k, widths):
    g = torch.Generator().manual_seed(1)
    m, c1 = 300, widths[0]
    h1 = torch.randn(1, k, m, c1, generator=g)
    mask = torch.rand(1, m, k, generator=g) > 0.3
    aff = (0.5 + torch.rand(c1, generator=g), 0.1 * torch.randn(c1, generator=g))
    layers = lambda ws: tuple(  # noqa: E731
        (torch.randn(a, b, generator=g) / a ** 0.5,
         0.1 * torch.randn(b, generator=g)) for a, b in zip(ws[:-1], ws[1:]))
    local = layers(widths)
    att = layers((widths[-1],) * 3) if aggr == "attend" else None
    move = lambda ls: None if ls is None else tuple(  # noqa: E731
        (w.to(dev), b.to(dev)) for w, b in ls)
    args = (h1.to(dev), mask.to(dev), tuple(t.to(dev) for t in aff),
            move(local), move(att))
    kw = dict(aggr=aggr, act="leaky_relu")
    got = group_reduce.group_reduce(*args, **kw)
    assert _rel_err(got, group_reduce.group_reduce_ref(*args, **kw)) <= 1e-4


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


def test_small_scan_matches_cpu_path(dev):
    """The flagship at n_pad 2048: GPU kernels vs the CPU plain path."""
    scan = predict.synthetic_scan(0, 2048, torch.device("cpu"))
    cpu = predict.predict(predict.build_model("configs/nuscenes.yaml", 2048,
                                              "cpu"), *scan)[0]
    gpu = predict.predict(predict.build_model("configs/nuscenes.yaml", 2048,
                                              dev), *(t.to(dev) for t in scan))[0]
    valid = scan[3]
    assert np.abs((gpu.cpu() - cpu)[valid].numpy()).max() <= 2e-3


@pytest.mark.parametrize("aggr,k,m,dims,a", [
    ("attend", 25, 300, (64, 128, 192, 256), 256),
    ("attend", 32, 200, (512, 512, 512), 256),
    ("max", 21, 300, (64, 64, 64), 0),
    ("max", 32, 100, (1024, 1024, 1024), 0),
    ("max", 21, 150, (1024, 1024), 0)])
def test_group_train_kernels(dev, aggr, k, m, dims, a):
    g = torch.Generator().manual_seed(4)
    h1 = torch.randn(2, k, m, dims[0], generator=g)
    mask = torch.rand(2, m, k, generator=g) > 0.4
    mask[0, 7] = False
    mask[:, :, ::4] = False    # planes no query of a tile reaches: skipped
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
    args = (h1.to(dev), mask.to(dev), cfg, tuple(p.to(dev) for p in params))
    out, stats, n, extras = group_train.group_train_fwd(*args)
    r_out, r_stats, r_n, r_extras = group_train.group_train_fwd_ref(*args)
    rows = mask.to(dev).any(-1)
    assert _rel_err(out[rows], r_out[rows]) <= 1e-4
    for (mu, var), (r_mu, r_var) in zip(stats, r_stats):
        assert _rel_err(mu, r_mu) <= 1e-4 and _rel_err(var, r_var) <= 1e-4
    dout = torch.randn(2, m, dims[-1], generator=g).to(dev) * rows[..., None]
    # each backward takes its own forward's residuals: a max aggregation's
    # ties are exact equalities of recomputed values
    d_h1, grads = group_train.group_train_bwd(*args, stats, n, extras, dout)
    r_h1, r_grads = group_train.group_train_bwd_ref(*args, r_stats, r_n,
                                                    r_extras, dout)
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
