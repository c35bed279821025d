"""Data parallelism over processes (counterpart of
``curvecloudnet_tpu/parallel/mesh.py``).

The JAX package jits its train step over a device mesh with the batch
sharded and the parameters replicated, so the program is written over the
global batch: every train-mode BatchNorm normalizes with the whole global
batch's statistics, the losses divide by global counts, Lovász sorts the
global rows and the samplers draw per global sample.  The port computes
the same step in R processes holding B/R samples each: the statistics,
counts and loss terms are summed over the processes where the step forms
them (``models/layers.py``, kernels K7 and K8 between their passes,
``run/losses.py``), the gradients are summed after the backward
(:func:`sum_gradients`), and a step over R processes equals the
single-process step on the global batch of B.

Every helper here is the identity, with no collective and no host sync,
when no process group is initialized (one process), and inside
:func:`local` (an unsharded eval that every process runs alike).

Backend: ``nccl`` when every process has a CUDA device of its own,
``gloo`` on the CPU or when processes share a card (NCCL refuses two
ranks on one device; gloo takes CUDA tensors through the host).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

# collectives off: inside local()
_LOCAL = [False]
# collective_timer()'s record while one is open
_TIMER = [None]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes of the run: the process group's size, else 1."""
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank, else 0."""
    return dist.get_rank() if _initialized() else 0


def world() -> int:
    """The processes a step's sums run over: :func:`process_count`, or 1
    inside :func:`local`."""
    return 1 if _LOCAL[0] else process_count()


def is_primary() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return process_index() == 0


@contextlib.contextmanager
def local():
    """Run the block as one process would (no collective): an eval that
    every process runs over the whole set."""
    prev = _LOCAL[0]
    _LOCAL[0] = True
    try:
        yield
    finally:
        _LOCAL[0] = prev


def local_device(device: torch.device, process_id: int) -> torch.device:
    """A process's device: ``cuda:{LOCAL_RANK or process_id % count}`` for
    CUDA, the CPU as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local_rank = os.environ.get("LOCAL_RANK")
    idx = (int(local_rank) if local_rank is not None
           else process_id % max(1, torch.cuda.device_count()))
    return torch.device("cuda", idx)


def backend_for(device: torch.device, num_processes: int) -> str:
    """The backend for processes on ``device`` (the device the run asked
    for, before :func:`local_device`): ``nccl`` when every process of this
    host (``LOCAL_WORLD_SIZE``, else all of them) has a CUDA device of its
    own, ``gloo`` on the CPU or when processes share a card: a device that
    names a card (every process of the host on it), or more processes than
    cards."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    here = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if device.index is not None:
        return "nccl" if here == 1 else "gloo"
    return "nccl" if here <= torch.cuda.device_count() else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: torch.device = torch.device("cpu"),
                           timeout_s: float = 600.0) -> int:
    """Join the process group at ``tcp://coordinator`` (``host:port``;
    process 0 serves it) -> this process's rank.  ``device`` is the
    device the run asked for: ``cuda`` spreads the processes over the
    cards, ``cuda:i`` puts every one on card i (:func:`local_device`,
    :func:`backend_for`).  A no-op for one process or a group already
    joined."""
    if not num_processes or num_processes <= 1 or _initialized():
        return process_index()
    if not coordinator:
        raise ValueError("distributed.num_processes > 1 needs "
                         "distributed.coordinator_address (host:port)")
    import datetime

    backend = backend_for(device, num_processes)
    mine = local_device(device, int(process_id or 0))
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id or 0),
        timeout=datetime.timedelta(seconds=timeout_s))
    if is_primary():
        print(f"[distributed] {num_processes} processes, backend {backend} "
              "(nccl when every process has a CUDA device of its own; gloo "
              "on the CPU or when processes share a card, as when the "
              "device names one)", flush=True)
    return process_index()


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if _initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def collective_timer():
    """Time every collective made inside the block: yields a dict that
    holds ``seconds`` (host wall inside the collectives) and ``calls``.
    Before each, the device is synchronized and the processes meet at an
    untimed barrier, so neither this process's queued kernels nor the
    wait for a slower process are counted; the barriers add to the
    block's wall."""
    rec = {"seconds": 0.0, "calls": 0}
    _TIMER[0] = rec
    try:
        yield rec
    finally:
        _TIMER[0] = None


def _collective(fn, *args):
    """``fn(*args)`` (a ``torch.distributed`` collective), timed inside
    :func:`collective_timer`."""
    rec = _TIMER[0]
    if rec is None:
        return fn(*args)
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    if fn is not dist.barrier:
        dist.barrier()
    t0 = time.perf_counter()
    out = fn(*args)
    if cuda:
        torch.cuda.synchronize()
    rec["seconds"] += time.perf_counter() - t0
    rec["calls"] += 1
    return out


def barrier() -> None:
    if world() > 1:
        _collective(dist.barrier)


def agree(value: float) -> float:
    """Process 0's ``value`` on every process (a decision every process
    must take alike, e.g. whether a score is a new best)."""
    if world() == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    _collective(dist.broadcast, t, 0)
    return float(t[0])


def process_shard_range(n_items: int) -> list:
    """This process's lockstep shard of a dataset: every process gets
    ceil(n / nproc) indices of the order wrap-padded with repetitions (the
    JAX package's ``process_shard_range``; unequal shards would deadlock
    the first collective)."""
    p, np_ = process_index(), process_count()
    per = -(-n_items // np_)
    idx = list(range(n_items))
    reps = -(-per * np_ // max(n_items, 1))
    idx = (idx * (reps + 1))[:per * np_]
    return idx[p * per:(p + 1) * per]


# ---------------------------------------------------------------------------
# sums over the processes
# ---------------------------------------------------------------------------


def reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the processes (a new tensor; no gradient), t itself
    at world 1."""
    if world() == 1:
        return t
    out = t.detach().clone()
    _collective(dist.all_reduce, out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the processes of t, on every process.  Each process's
    loss term reads its copy of y, so the cotangent of t is the sum of the
    processes' cotangents of y: the backward all-reduces too."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        _collective(dist.all_reduce, out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _collective(dist.all_reduce, g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over the processes; the identity at world 1."""
    if world() == 1:
        return t
    return _AllReduceSum.apply(t)


def _gather_rows(x: torch.Tensor):
    """(the rows of every process's x in rank order, this process's offset
    in them); see :func:`all_gather_rows`."""
    w = world()
    counts = torch.zeros(w, dtype=torch.int64, device=x.device)
    counts[process_index()] = x.shape[0]
    _collective(dist.all_reduce, counts)
    counts = counts.tolist()
    off = sum(counts[:process_index()])
    # gloo sums float32 exactly where it may lack half-precision sums
    wide = x.dtype in (torch.bfloat16, torch.float16, torch.bool)
    buf = torch.zeros((sum(counts), *x.shape[1:]),
                      dtype=torch.float32 if wide else x.dtype,
                      device=x.device)
    buf[off:off + x.shape[0]] = x.detach()
    _collective(dist.all_reduce, buf)
    return (buf.to(x.dtype) if wide else buf), off


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of every process's x (R_p, ...) in rank order (no
    gradient): an all-reduce of the row counts, then of a zero-filled
    global buffer holding each process's rows at its offset (gloo has no
    all-gather of CUDA tensors; x + 0 is exact)."""
    if world() == 1:
        return x
    return _gather_rows(x)[0]


def rank_rows(n: int) -> slice:
    """This process's rows of a global batch of n samples: the contiguous
    n / world of them at its rank."""
    w = world()
    if n % w:
        raise ValueError(f"a global batch of {n} does not split over {w} "
                         "processes")
    per = n // w
    r = process_index() if w > 1 else 0
    return slice(r * per, (r + 1) * per)


def global_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows around this process's x (B, ...): the other
    processes' rows gathered (no gradient) and x itself (with its
    gradient) at this process's offset; x itself at world 1."""
    if world() == 1:
        return x
    rows, off = _gather_rows(x)
    return torch.cat([rows[:off], x, rows[off + x.shape[0]:]])


def rand_rows(shape, generator: Optional[torch.Generator] = None,
              device=None) -> torch.Tensor:
    """``torch.rand(shape)`` of this process's rows: every process draws
    the global batch's (shape[0] x world, ...) from the same generator
    state and keeps its own rows, so a data-parallel step draws what the
    single-process step on the global batch draws.  A scalar (shape ())
    is shared."""
    shape = tuple(shape)
    w = world()
    if w == 1 or not shape:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((shape[0] * w, *shape[1:]), generator=generator,
                      device=device)
    return full[rank_rows(shape[0] * w)]


def moments(x: torch.Tensor, w: Optional[torch.Tensor] = None):
    """(mean, biased var, count) of the rows of x (R, C) weighted by w
    (R, 1) over every process's rows, differentiable in x: the count and
    the column sums all-reduced, then the centred squares (two passes, as
    ``MaskedBatchNorm``); the count clamped to at least 1 once, globally."""
    if w is None:
        w = x.new_ones((x.shape[0], 1))
    s = all_reduce_sum(torch.cat([(x * w).sum(dim=0), w.sum().reshape(1)]))
    cnt = torch.clamp(s[-1].detach(), min=1.0)
    mean = s[:-1] / cnt
    var = all_reduce_sum(((x - mean) ** 2 * w).sum(dim=0)) / cnt
    return mean, var, cnt


def merge_moments(mean: torch.Tensor, var: torch.Tensor, count):
    """Every process's (count, mean, biased var) of C columns merged into
    the global ones (Chan's formula, in rank order: the same on every
    process) -> (mean, var, global count clamped to at least 1); no
    gradient."""
    c = mean.numel()
    mine = torch.cat([torch.as_tensor(count, dtype=torch.float32,
                                      device=mean.device).reshape(1),
                      mean.float().reshape(-1), var.float().reshape(-1)])
    rows = all_gather_rows(mine[None])
    n = rows[:, :1]
    tot = torch.clamp(n.sum(), min=1.0)
    mu = (n * rows[:, 1:1 + c]).sum(dim=0) / tot
    m2 = (n * (rows[:, 1 + c:] + (rows[:, 1:1 + c] - mu) ** 2)).sum(dim=0)
    return mu, m2 / tot, tot


class _WithValue(torch.autograd.Function):
    """Forward ``value``, backward into ``share``: a loss whose value is the
    global one and whose gradient is this process's share of it."""

    @staticmethod
    def forward(ctx, share, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def with_value(share: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return _WithValue.apply(share, value.to(share.dtype).detach())


# ---------------------------------------------------------------------------
# the train step's state
# ---------------------------------------------------------------------------


def _bucketed(tensors, op) -> None:
    """Run ``op`` on one flat buffer a (device, dtype) of ``tensors`` and
    copy the results back."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    nccl = dist.get_backend() == "nccl"
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if nccl and flat.device.type != "cuda":   # nccl takes CUDA tensors
            flat = flat.cuda()
        op(flat)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def sum_gradients(params) -> None:
    """Sum every parameter's gradient over the processes (one all-reduce a
    dtype): the gradient of the global loss."""
    if world() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    _bucketed(grads, lambda flat: _collective(dist.all_reduce, flat))


def broadcast_state(model: torch.nn.Module, optimizer=None,
                    src: int = 0) -> None:
    """Make every process's parameters, buffers and optimizer state those
    of process ``src``."""
    if world() == 1:
        return
    tensors = [t.data for t in model.state_dict().values()]
    if optimizer is not None:
        for state in optimizer.state.values():
            tensors += [v for v in state.values() if torch.is_tensor(v)]
    _bucketed(tensors, lambda flat: _collective(dist.broadcast, flat, src))


def shard_batch(batch, rank: Optional[int] = None,
                world_size: Optional[int] = None):
    """This process's contiguous rows of a global batch (a dataclass of
    tensors with the batch leading, nested dataclasses included)."""
    rank = process_index() if rank is None else rank
    world_size = process_count() if world_size is None else world_size

    def cut(v):
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{
                f.name: cut(getattr(v, f.name))
                for f in dataclasses.fields(v)})
        if not torch.is_tensor(v):
            return v
        if v.shape[0] % world_size:
            raise ValueError(f"a batch of {v.shape[0]} does not split over "
                             f"{world_size} processes")
        per = v.shape[0] // world_size
        return v[rank * per:(rank + 1) * per]

    return cut(batch)


def sharded_train_step(step=None):
    """``step`` (``train.trainer.train_step`` by default) on this process's
    shard of a global batch: fn(model, optimizer, lr, batch, ...) ->
    metrics of the global step, the same on every process."""
    if step is None:
        from ..train.trainer import train_step as step

    def run(model, optimizer, lr, batch, *args, **kwargs):
        return step(model, optimizer, lr, shard_batch(batch), *args,
                    **kwargs)

    return run


def sharded_eval_step(model, batch, loss_cfg=None):
    """The eval forward of this process's shard of a global batch ->
    (logits, out_valid, loss) of the global batch: the logits gathered
    back in rank order, the loss of the gathered batch."""
    from ..train.trainer import LossConfig, compute_loss

    loss_cfg = LossConfig() if loss_cfg is None else loss_cfg
    mine = shard_batch(batch)
    with torch.no_grad():
        logits, out_valid = model(mine.cloud, mine.categories
                                  if model.spec.with_seg_category else None)
        logits, out_valid = all_gather_rows(logits), all_gather_rows(
            out_valid)
        with local():
            loss = compute_loss(logits, out_valid, batch, loss_cfg)
    return logits, out_valid, loss
