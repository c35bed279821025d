"""The port's data-parallel training over processes on the CPU, against
one process on the global batch and against the JAX package's sharded
step.

Rank processes run ``curvecloudnet_tpu_torch.parallel.dryrun`` (a gloo
group on 127.0.0.1, a free port each spawn, every spawn killed past its
deadline); they import the port alone.  Each case runs once over 2 ranks
(each holding half the global batch's samples) and once in this process
with no group (the single-process computation on the global batch):

* the loader's lockstep shards against JAX's ``_batch_indices`` /
  ``process_shard_range`` for world sizes 1-3, a set smaller than the
  world included;
* ``MaskedBatchNorm`` in train (with and without a mask), K7's autograd
  Function and K8's (the Function over the plain passes, and the plain
  chain) in float32 and bfloat16, and the losses (NLL with Lovász,
  KITTI's ``mean_over_all``, class weights, bfloat16 logits,
  classification): outputs, statistics and gradients at rounding level
  (1e-5 of max(1, |value|); gradients 1e-5 of the quantity's largest);
* a whole Adam step of ``tests/test_train_e2e.py``'s ``TINY_MODEL``
  (conv1d-fast-v2, sgcnn, FPS sa, fp; Lovász on) over 2 ranks x B=2:
  loss 1e-5 relative, gradients rtol 5e-2 atol 1e-5 (JAX's own DP bar,
  ``test_sharded_train_step_matches_single``), running statistics 1e-5,
  parameters after the step, against the port's single-process B=4 step
  (also with a sampling generator: the ranks draw the global batch's
  starts) and against JAX's ``sharded_train_step`` on a 2-device mesh
  from the same weights (``from_jax_variables``);
* ``main`` with ``distributed.num_processes: 2`` on the CPU: an epoch of 2
  steps a process, val, process 0's checkpoint, then resumed.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from curvecloudnet_tpu.data import datasets as JD
from curvecloudnet_tpu.data import loader as JL
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.parallel import make_mesh
from curvecloudnet_tpu.parallel import mesh as jmesh
from curvecloudnet_tpu.parallel import shard_batch, sharded_train_step
from curvecloudnet_tpu.train import LossConfig as JLossConfig
from curvecloudnet_tpu.train.trainer import TrainState, _compute_loss
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch.config import load_config
from curvecloudnet_tpu_torch.data import loader as TL
from curvecloudnet_tpu_torch.parallel import dryrun
from curvecloudnet_tpu_torch.parallel import mesh as tmesh
from test_torch_port_eval import random_variables
from test_train_e2e import TINY_MODEL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
B, N_PAD, N_OUT, LR = 4, 64, 5, 1e-3
LOSS = dict(task="segmentation", ignore_index=0, use_lovasz=True)


# ---------------------------------------------------------------------------
# the loader's shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("n", [2, 7, 12])
def test_loader_shards_match_jax(world, n, monkeypatch):
    ds = JD.SyntheticLidarSeg(n_samples=n, n_pad=32, n_beams=4)
    covered = set()
    for rank in range(world):
        for mod in (jax, tmesh):
            monkeypatch.setattr(mod, "process_count", lambda: world)
            monkeypatch.setattr(mod, "process_index", lambda r=rank: r)
        for kw in (dict(shuffle=True), dict(drop_last=False)):
            tl, jl = TL.PrefetchLoader(ds, 2, **kw), JL.PrefetchLoader(ds, 2,
                                                                        **kw)
            want = [list(b) for b in jl._batch_indices(5)]
            assert [list(b) for b in tl._batch_indices(5)] == want
            assert len(tl) == len(jl)
        shard = tmesh.process_shard_range(n)
        assert shard == jmesh.process_shard_range(n)
        assert len(shard) == -(-n // world)
        covered |= set(shard)
    assert covered == set(range(n))


# ---------------------------------------------------------------------------
# the pieces and the step over 2 ranks
# ---------------------------------------------------------------------------


def _f(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _k7(rng, aggr, bf16=False, dims=(6, 8, 7), a=5, empty_rank=False):
    b, k, m = B, 5, 6
    params = []
    for i in range(len(dims) - 1):
        params += [1 + 0.1 * _f(rng, dims[i]), 0.1 * _f(rng, dims[i]),
                   _f(rng, dims[i], dims[i + 1]) / 3,
                   0.1 * _f(rng, dims[i + 1])]
    if aggr == "attend":
        cl = dims[-1]
        params += [_f(rng, cl, a) / 3, 0.1 * _f(rng, a), 1 + 0.1 * _f(rng, a),
                   0.1 * _f(rng, a), _f(rng, a, cl) / 3, 0.1 * _f(rng, cl)]
    mask = rng.random((b, m, k)) < 0.6
    mask[0, 0] = False          # a query with no live slot
    mask[1] = False             # a sample with no live row
    if empty_rank:              # rank 1's samples: no live row at all
        mask[B // 2:] = False
    return dict(cfg=dict(dims=dims, att_dim=a if aggr == "attend" else 0,
                         aggr=aggr, act="leaky_relu"),
                h1=_f(rng, b, k, m, dims[0]), mask=mask, params=params,
                dout=_f(rng, b, m, dims[-1]), bf16=bf16)


def _k8(rng, route, bf16=False, half_k=1, widths=(4, 6, 5), n_exp=20,
        empty_rank=False):
    params = [(_f(rng, (half_k + 1) * widths[i], widths[i + 1]) / 3,
               0.1 * _f(rng, widths[i + 1]), 1 + 0.1 * _f(rng, widths[i + 1]),
               0.1 * _f(rng, widths[i + 1])) for i in range(len(widths) - 1)]
    used = rng.integers(8, n_exp + 1, B)
    used[1] = 0                 # a sample with no live slot
    if empty_rank:              # rank 1's samples: no live slot at all
        used[B // 2:] = 0
    return dict(xe=_f(rng, B, n_exp, widths[0]), used=used, params=params,
                half_k=half_k, cot=_f(rng, B, n_exp, widths[-1]),
                route=route, bf16=bf16)


def _pieces():
    rng = np.random.default_rng(0)
    n, c = 16, 6
    mask = rng.random((B, n)) < 0.7
    cases = [("bn", dict(x=_f(rng, B, n, c), mask=mask, cot=_f(rng, B, n, c),
                         w=1 + 0.1 * _f(rng, c), b=0.1 * _f(rng, c)))]
    logits = _f(rng, B, n, c)
    labels = rng.integers(0, c, (B, n))
    cases.append(("loss", dict(
        logits=logits, labels=labels, valid=mask,
        seg={"nll_lovasz": dict(use_lovasz=True, ignore_index=0),
             "mean_over_all": dict(ignore_index=0, mean_over_all=True),
             "class_weights": dict(ignore_index=0, class_weights=rng.random(
                 c).astype(np.float32)),
             "bf16": dict(use_lovasz=True, ignore_index=0, bf16=True)},
        cls_logits=logits[:, 0], cls_labels=labels[:, 0])))
    cases += [("k7:max", _k7(rng, "max")),
              ("k7:attend", _k7(rng, "attend", empty_rank=True)),
              ("k7:bf16", _k7(rng, "attend", bf16=True)),
              ("k8:passes", _k8(rng, "passes", half_k=2)),
              ("k8:empty_rank", _k8(rng, "passes", empty_rank=True)),
              ("k8:chain", _k8(rng, "chain")),
              ("k8:bf16", _k8(rng, "passes", bf16=True)),
              ("rows", dict(x=_f(rng, 4, 3), cot=_f(rng, 4, 3),
                            counts=[1, 3]))]
    return cases


def _model(model_cfg, n_pad, n_out, batch, n_beams, seed=3):
    """A JAX model, its numpy batch of ``batch`` sweeps, numpy weights, and
    the port's step case of them (``parallel.dryrun.case_step``)."""
    jspec = jparse(model_cfg, in_dim=4, n_out=n_out)
    jm = JNet(jspec, n_points=n_pad)
    ds = JD.SyntheticLidarSeg(n_samples=batch, n_pad=n_pad, n_classes=n_out,
                              n_beams=n_beams, seed=seed)
    np_batch = next(JD.batch_iterator(ds, batch))
    jb = JD.to_device_batch(np_batch, "segmentation")
    variables = random_variables(jm, jb.cloud)
    state = {k: v.numpy() for k, v in tckpt.from_jax_variables(
        variables["params"], variables["batch_stats"], jspec).items()}
    case = dict(model=model_cfg, in_dim=4, n_out=n_out, n_pad=n_pad,
                state=state, batch=np_batch, lr=LR, loss=LOSS)
    return (jspec, jm, jb, variables), case


@pytest.fixture(scope="module")
def runs():
    """Every case over 2 ranks and in one process: (single, [rank 0,
    rank 1], the tiny model's JAX pieces)."""
    jax_tiny, step = _model(TINY_MODEL, N_PAD, N_OUT, B, n_beams=4)
    cases = _pieces() + [("step", step),
                         ("step:generator", dict(step, gen_seed=3)),
                         ("eval", step)]
    torch.set_num_threads(2)
    single = dryrun.run_cases(cases)
    ranks = dryrun.run_ranks(cases, WORLD, timeout=120)
    return single, ranks, jax_tiny


def _same_on_ranks(ranks, key):
    a, b = ranks[0][key], ranks[1][key]
    flat_a, flat_b = _flat(a), _flat(b)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert torch.equal(flat_a[k], flat_b[k]), (key, k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}[{i}]").items()}
    return {prefix: tree.detach().float()}


def _close(got, want, grads=()):
    """Every leaf within 1e-5 of max(1, |want|); a leaf named in ``grads``
    (a gradient) within 1e-5 of its largest magnitude plus 1e-5 of the
    case's largest gradient (a bias feeding a BatchNorm has a gradient
    that is 0 in exact arithmetic: rounding noise on both sides)."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    big = {k: float(v.abs().max()) if v.numel() else 0.0
           for k, v in w.items()}
    is_grad = {k: any(s in k for s in grads) for k in w}
    floor = max([big[k] for k in w if is_grad[k]] + [0.0])
    for k, v in w.items():
        err = float((g[k] - v).abs().max()) if v.numel() else 0.0
        bound = big[k] + floor if is_grad[k] else max(1.0, big[k])
        assert err <= 1e-5 * bound, (k, err, bound)


PIECES = ["bn", "loss", "rows", "k7:max", "k7:attend", "k7:bf16", "k8:passes",
          "k8:empty_rank", "k8:chain", "k8:bf16"]


@pytest.mark.parametrize("name", PIECES)
def test_piece_over_ranks_matches_one_process(runs, name):
    single, ranks, _ = runs
    _same_on_ranks(ranks, name)
    _close(ranks[0][name], single[name],
           grads=("grads", "dw", "db", "dx", "dh1", "dxe", "grad"))


def _check_step(got, want):
    """Loss 1e-5 relative, gradients rtol 5e-2 atol 1e-5, running
    statistics 1e-5, parameters after the Adam step: at entries whose
    gradient is above 1e-3 of the model's largest within 1e-6 (there the
    first Adam step is -lr sign(g)), elsewhere within 2 lr (Adam's step on
    a gradient near rounding size, e.g. a bias feeding a BatchNorm, whose
    gradient is 0 in exact arithmetic)."""
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(
        float(want["loss"]))
    assert got["grads"].keys() == want["grads"].keys()
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                   rtol=5e-2, atol=1e-5, err_msg=k)
    for k, v in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    top = max(float(g.abs().max()) for g in want["grads"].values())
    for k, p in want["params"].items():
        sure = want["grads"][k].abs() > 1e-3 * top
        err = (got["params"][k] - p).abs()
        assert not bool(sure.any()) or float(err[sure].max()) <= 1e-6, k
        assert float(err.max()) <= 2 * LR + 1e-6, k


@pytest.mark.parametrize("name", ["step", "step:generator"])
def test_step_over_ranks_matches_one_process(runs, name):
    single, ranks, _ = runs
    _same_on_ranks(ranks, name)
    _check_step(ranks[0][name], single[name])


def test_eval_over_ranks_matches_one_process(runs):
    """``sharded_eval_step``: the global batch's logits gathered back, its
    loss, on every rank."""
    single, ranks, _ = runs
    _same_on_ranks(ranks, "eval")
    _close(ranks[0]["eval"], single["eval"])


def _jax_sharded_step(jspec, jm, jb, variables):
    """JAX's ``sharded_train_step`` over a 2-device mesh (the deterministic
    sampling point) -> the loss, gradients, running statistics and
    parameters after the step, under the port's names."""
    cfg = JLossConfig(**LOSS)

    def raw(state, batch, key, bn_momentum):
        def loss_fn(params):
            (logits, ov), mut = jm.apply(
                {"params": params, "batch_stats": state.batch_stats},
                batch.cloud, batch.categories, train=True,
                bn_momentum=bn_momentum, mutable=["batch_stats"])
            return _compute_loss(logits, ov, batch, cfg, None), \
                mut["batch_stats"]

        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return state.apply_gradients(grads, bs), {"loss": loss,
                                                  "grads": grads}

    tx = optax.adam(LR)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params), tx=tx)
    mesh = make_mesh(WORLD)
    new, m = sharded_train_step(raw, mesh)(state, shard_batch(jb, mesh),
                                           jax.random.PRNGKey(0),
                                           jnp.float32(0.1))
    sd = tckpt.from_jax_variables(new.params, new.batch_stats, jspec)
    return {"loss": torch.tensor(float(m["loss"])),
            "grads": tckpt.from_jax_variables(m["grads"], {}, jspec),
            "buffers": {k: v for k, v in sd.items() if ".running_" in k},
            "params": {k: v for k, v in sd.items() if ".running_" not in k}}


def test_step_over_ranks_matches_jax_sharded_step(runs):
    """The 2-rank step against JAX's ``sharded_train_step`` over a 2-device
    mesh from the same weights."""
    _, ranks, jax_tiny = runs
    _check_step(ranks[0]["step"], _jax_sharded_step(*jax_tiny))


@pytest.mark.slow
def test_flagship_step_over_ranks_matches_jax_sharded_step():
    """The narrow flagship (nuScenes widths / 16, n_pad 512, B=2: a sweep a
    rank) over 2 ranks against JAX's sharded step: loss 1e-4 relative,
    running statistics 1e-4, each gradient (L2) within 3x JAX's own change
    under a 1e-6 weight perturbation plus 2e-3 of its norm (train-mode
    BatchNorm over 33 steps amplifies rounding, as
    ``test_torch_port_train_model``'s slice test holds it)."""
    from curvecloudnet_tpu_torch.tools.multiproc_dryrun import \
        shrink_feat_dims

    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    jax_net, case = _model(shrink_feat_dims(cfg["model"], 16), 512, 17, 2,
                           n_beams=32)
    got = dryrun.run_ranks([("step", case)], WORLD, timeout=600)[0]["step"]
    want = _jax_sharded_step(*jax_net)
    jspec, jm, jb, variables = jax_net
    noise = np.random.default_rng(9)
    shaken = dict(variables, params=jax.tree_util.tree_map(
        lambda leaf: leaf * (1 + 1e-6 * noise.standard_normal(
            leaf.shape)).astype(np.float32), variables["params"]))
    yard = _jax_sharded_step(jspec, jm, jb, shaken)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4 * abs(
        float(want["loss"]))
    for k, v in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k, g in want["grads"].items():
        err = float((got["grads"][k] - g).norm())
        moved = float((yard["grads"][k] - g).norm())
        assert err <= 3 * moved + 2e-3 * float(g.norm()), (k, err, moved)


def test_multiproc_dryrun_tool():
    """``tools/multiproc_dryrun``'s counterpart on the CPU at a tiny size:
    2 processes, one data-parallel step of the narrow flagship, the loss
    bit-identical on both, equal shards covering the set."""
    from curvecloudnet_tpu_torch.tools import multiproc_dryrun

    multiproc_dryrun.main(["--n-pad", "128", "--div", "32", "--per-proc",
                           "1", "--timeout", "120"])


# ---------------------------------------------------------------------------
# main over 2 processes
# ---------------------------------------------------------------------------


def test_main_two_processes_train_validate_resume(tmp_path):
    """An epoch through ``distributed.num_processes: 2`` (a process a
    ``CCN_PROCESS_ID``), then resumed for a second through
    ``data_parallel_devices: 2`` (``main`` spawning its processes; on the
    CPU only where its device check is bypassed, as here)."""
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    outdir = str(tmp_path / "run")
    cfg.update(model=TINY_MODEL, n_pad=128, n_train=4, n_val=1,
               batch_size=1, num_workers=1, device="cpu", outdir=outdir,
               data_path=str(tmp_path / "none"), use_tta=False)
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    port = dryrun.free_port()
    outs = dryrun.spawn(
        lambda i: [sys.executable, "-m", "curvecloudnet_tpu_torch.main",
                   "--config", path, "--epochs=1",
                   "--distributed.num_processes", "2",
                   "--distributed.coordinator_address", f"127.0.0.1:{port}"],
        WORLD, timeout=120, env_of=lambda i: {"CCN_PROCESS_ID": str(i),
                                              "OMP_NUM_THREADS": "2"})
    spawned = ("import sys; from curvecloudnet_tpu_torch import main as m; "
               "from curvecloudnet_tpu_torch.config import parse_args; "
               "m._data_parallel = lambda cfg: 2; "
               "print('score', m.main(parse_args(sys.argv[1:])))")
    outs += dryrun.spawn(
        lambda i: [sys.executable, "-c", spawned, "--config", path,
                   "--epochs=2", "--data_parallel_devices=2"],
        1, timeout=120, env_of=lambda i: {"OMP_NUM_THREADS": "2"})
    assert "backend gloo" in outs[0] and "backend gloo" in outs[2]
    for i, out in enumerate(outs):
        assert f"epoch {i // 2}: loss" in out, out
    assert outs[2].count("resumed from") == 2      # both spawned processes
    assert "score " in outs[2]
    with open(os.path.join(outdir, "latest_state.json")) as f:
        assert json.load(f)["epoch"] == 1
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        scores = [r for r in map(json.loads, f) if "score" in r]
    assert [r["epoch"] for r in scores] == [0, 1]   # process 0 alone logs
    # 2 steps a process an epoch: the optimizer's step count after 2 epochs
    blob = torch.load(os.path.join(outdir, "latest", tckpt.CHECKPOINT_FILE),
                      weights_only=True)
    assert blob["step"] == 4


def test_backend_rule_and_data_parallel_devices(monkeypatch, capsys):
    """gloo on the CPU and when processes share a card, nccl when every
    process has one; ``data_parallel_devices`` spawns a process a visible
    GPU and runs one process with fewer."""
    from curvecloudnet_tpu_torch import main as tmain

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.backend_for(torch.device("cpu"), 2) == "gloo"
    assert tmesh.backend_for(torch.device("cuda"), 2) == "nccl"
    assert tmesh.backend_for(torch.device("cuda"), 4) == "gloo"
    # a device that names a card: every process of the host on it
    assert tmesh.backend_for(torch.device("cuda", 0), 2) == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert tmesh.backend_for(torch.device("cuda"), 8) == "nccl"
    assert tmesh.backend_for(torch.device("cuda", 1), 8) == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert tmesh.backend_for(torch.device("cuda", 1), 8) == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert tmesh.local_device(torch.device("cuda"), 3) == torch.device(
        "cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert tmesh.local_device(torch.device("cuda"), 3) == torch.device(
        "cuda", 0)
    assert tmain._data_parallel({"data_parallel_devices": 2}) == 2
    assert tmain._data_parallel({"data_parallel_devices": 3}) is None
    assert "running one process" in capsys.readouterr().out
    assert tmain._data_parallel({"data_parallel_devices": 2,
                                 "device": "cpu"}) is None


@pytest.mark.parametrize("device,backend,cards", [
    ("cuda:0", "gloo", [0, 0]), ("cuda", "nccl", [0, 1])])
@pytest.mark.parametrize("pid", [0, 1])
def test_main_entry_backend_follows_the_cards(device, backend, cards, pid,
                                              monkeypatch):
    """``main``'s distributed entry on a host of 2 cards: a device that
    names a card puts both processes on it over gloo; ``cuda`` gives each
    process a card of its own, over nccl."""
    from curvecloudnet_tpu_torch import main as tmain

    for var in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("device", torch.device(d)))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    tmain.init_distributed_from_config({"device": device, "distributed": {
        "num_processes": 2, "coordinator_address": "127.0.0.1:1",
        "process_id": pid}})
    assert seen["backend"] == backend
    assert seen["device"] == torch.device("cuda", cards[pid])
    assert (seen["rank"], seen["world_size"]) == (pid, 2)
