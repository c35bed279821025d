"""Rank processes on one machine: a launcher with a deadline, and a rank
entry that runs data-parallel cases of the port's train pieces.

:func:`spawn` starts one process a rank (``python -m ...``, outputs to
files), kills them all when one fails or the deadline passes, and raises
with their outputs.  The rank entry::

    python -m curvecloudnet_tpu_torch.parallel.dryrun --rank 0 --world 2 \\
        --port 29500 --inputs cases.pt --out out_{rank}.pt [--device cpu]

joins a ``gloo`` group on ``127.0.0.1:port`` and runs each case of
``cases.pt`` (``{"cases": [(name, inputs), ...]}``) on its rows of the
case's global batch, writing ``{name: outputs}``.  The same case run in
one process with no group (:func:`run_cases`) is the single-process
computation on the global batch, so the two can be compared: every
output is global (rows gathered in rank order, per-process sums of
parameter gradients summed over the processes, as the trainer sums
them).  Cases: ``bn`` (``MaskedBatchNorm`` in train), ``k7`` (K7's
autograd Function), ``k8`` (K8's chain: the Function over the passes or
the plain chain), ``loss`` (the segmentation and classification losses),
``rows`` (``global_rows`` over unequal row counts), ``step`` (a whole train step through ``parallel.sharded_train_step``)
and ``eval`` (``parallel.sharded_eval_step``).  The entry imports the
port alone.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import mesh as parallel

MODULE = "curvecloudnet_tpu_torch.parallel.dryrun"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port of 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv_of, world: int, timeout: float = 120.0, env_of=None,
          cwd: str = REPO) -> list:
    """Run ``world`` processes (``argv_of(rank)``: the command of a rank;
    ``env_of(rank)``: variables added to its environment) to their end ->
    each one's output (stdout and stderr).  Raises when one exits non-zero
    (the others are killed: they would wait in a collective) or when the
    deadline passes (all are killed).  Each rank runs in a session of its
    own and a kill takes the session, processes it started included."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{i}.log"), "w+")
                for i in range(world)]
        procs = [subprocess.Popen(
            argv_of(i), stdout=logs[i], stderr=subprocess.STDOUT,
            env=dict(env, **(env_of(i) if env_of else {})), cwd=cwd,
            start_new_session=True) for i in range(world)]

        def kill(p):
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:   # the session has ended
                pass
            p.wait()

        def outputs():
            out = []
            for f in logs:
                f.flush()
                f.seek(0)
                out.append(f.read())
            return out

        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [i for i, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    why = (f"rank {failed[0]} exited {codes[failed[0]]}"
                           if failed else f"deadline of {timeout:.0f} s")
                    for p in procs:
                        kill(p)
                    raise RuntimeError(f"rank processes failed ({why}):\n" +
                                       "\n".join(f"--- rank {i}\n{o[-4000:]}"
                                                 for i, o in
                                                 enumerate(outputs())))
                if all(c == 0 for c in codes):
                    return outputs()
                time.sleep(0.05)
        finally:
            for p in procs:
                kill(p)
            for f in logs:
                f.close()


def run_ranks(cases, world: int, timeout: float = 120.0,
              device: str = "cpu") -> list:
    """The cases of :func:`run_cases` over ``world`` rank processes ->
    each rank's ``{name: outputs}``."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "cases.pt")
        torch.save({"cases": cases}, src)
        port = free_port()
        out = os.path.join(tmp, "out_{rank}.pt")
        spawn(lambda i: [sys.executable, "-m", MODULE, "--rank", str(i),
                         "--world", str(world), "--port", str(port),
                         "--inputs", src, "--out", out, "--device", device],
              world, timeout)
        return [torch.load(out.format(rank=i), weights_only=False)
                for i in range(world)]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _t(a, device, dtype=None):
    t = torch.as_tensor(np.asarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _rows(t):
    """This process's rows of a global batch."""
    return t[parallel.rank_rows(t.shape[0])]


def _gather(t):
    return parallel.all_gather_rows(t.detach()).cpu()


def _sum(t):
    return parallel.reduce_sum(t.detach()).cpu()


def case_bn(inp, device):
    """``MaskedBatchNorm`` in train over (B, N, C) rows with and without a
    mask: outputs, input and affine gradients under a fixed cotangent, the
    updated running statistics."""
    from ..models.layers import MaskedBatchNorm

    out = {}
    x, cot = _t(inp["x"], device), _t(inp["cot"], device)
    for key, mask in (("mask", _t(inp["mask"], device)), ("none", None)):
        bn = MaskedBatchNorm(x.shape[-1]).to(device)
        with torch.no_grad():
            bn.weight.copy_(_t(inp["w"], device))
            bn.bias.copy_(_t(inp["b"], device))
        xl = _rows(x).clone().requires_grad_()
        y = bn(xl, None if mask is None else _rows(mask), train=True,
               momentum=0.1)
        (y * _rows(cot)).sum().backward()
        out[key] = {"y": _gather(y), "dx": _gather(xl.grad),
                    "dw": _sum(bn.weight.grad), "db": _sum(bn.bias.grad),
                    "running_mean": bn.running_mean.cpu(),
                    "running_var": bn.running_var.cpu()}
    return out


def case_k7(inp, device):
    """K7's autograd Function (``group_train._GroupTrain``; the plain passes
    on CPU tensors, the kernels on CUDA ones): output, statistics, count,
    d_h1 and the parameter gradients under a fixed cotangent."""
    from ..ops import group_train

    cfg = group_train.TrainCfg(**inp["cfg"])
    dtype = torch.bfloat16 if inp.get("bf16") else torch.float32
    h1 = _rows(_t(inp["h1"], device, dtype)).clone().requires_grad_()
    params = [_t(p, device).requires_grad_() for p in inp["params"]]
    out, n, *flat = group_train._GroupTrain.apply(
        cfg, h1, _rows(_t(inp["mask"], device)), *params)
    (out * _rows(_t(inp["dout"], device))).sum().backward()
    return {"out": _gather(out), "n": n.cpu(),
            "stats": [s.cpu() for s in flat], "dh1": _gather(h1.grad.float()),
            "grads": [_sum(p.grad) for p in params]}


def case_k8(inp, device):
    """K8's chain: ``route`` "passes" (``_Conv1dChainTrain``, the plain
    passes on CPU tensors) or "chain" (the plain chain under torch
    autograd): output, statistics, d_xe and the parameter gradients."""
    from ..ops import conv1d_train as C

    dtype = torch.bfloat16 if inp.get("bf16") else torch.float32
    xe = _rows(_t(inp["xe"], device, dtype)).clone().requires_grad_()
    params = [tuple(_t(p, device).requires_grad_() for p in layer)
              for layer in inp["params"]]
    fn = (C.conv1d_chain_passes if inp["route"] == "passes"
          else C.conv1d_chain_train_ref)
    out, stats = fn(xe, params, _rows(_t(inp["used"], device)),
                    inp["half_k"])
    (out.float() * _rows(_t(inp["cot"], device))).sum().backward()
    return {"out": _gather(out.float()), "n": stats[0][2].cpu(),
            "stats": [t.cpu() for s in stats for t in s[:2]],
            "dxe": _gather(xe.grad.float()),
            "grads": [_sum(p.grad) for layer in params for p in layer]}


def case_loss(inp, device):
    """The losses of ``run/losses.py`` on (B, N, C) logits: the value and
    the logits' gradient of each variant in ``inp["seg"]`` (keyword
    arguments of ``seg_loss``; ``bf16``: bfloat16 logits) and of the
    classification loss on the (B, C) ``cls_logits``."""
    from ..run import losses

    out = {}
    labels, valid = _t(inp["labels"], device), _t(inp["valid"], device)
    for key, kw in inp["seg"].items():
        kw = dict(kw)
        dtype = torch.bfloat16 if kw.pop("bf16", False) else torch.float32
        if kw.get("class_weights") is not None:
            kw["class_weights"] = _t(kw["class_weights"], device)
        lg = _rows(_t(inp["logits"], device, dtype)).clone().requires_grad_()
        loss = losses.seg_loss(lg, _rows(labels), _rows(valid), **kw)
        loss.backward()
        out[key] = {"loss": loss.detach().float().cpu(),
                    "grad": _gather(lg.grad.float())}
    lg = _rows(_t(inp["cls_logits"], device)).clone().requires_grad_()
    loss = losses.classification_loss(lg, _rows(_t(inp["cls_labels"],
                                                    device)))
    loss.backward()
    out["classification"] = {"loss": loss.detach().cpu(),
                             "grad": _gather(lg.grad)}
    return out


def case_rows(inp, device):
    """``parallel.global_rows`` where the processes hold unequal row counts
    (``inp["counts"]``, one a process): the global rows and the gradient
    of a fixed cotangent through them."""
    x = _t(inp["x"], device)
    if parallel.world() > 1:
        counts, r = inp["counts"], parallel.process_index()
        x = x[sum(counts[:r]):sum(counts[:r + 1])]
    xl = x.clone().requires_grad_()
    rows = parallel.global_rows(xl)
    (rows * _t(inp["cot"], device)).sum().backward()
    return {"rows": rows.detach().cpu(), "dx": _gather(xl.grad)}


def _model(inp, device):
    """(model ``inp["model"]`` (a config's model block) at ``n_pad`` with
    the weights ``inp["state"]``, the global numpy batch ``inp["batch"]``
    on ``device``, its loss config)."""
    from ..data.datasets import to_device_batch
    from ..models import CurveCloudNet, parse_model_config
    from ..train.trainer import LossConfig

    spec = parse_model_config(inp["model"], in_dim=inp["in_dim"],
                              n_out=inp["n_out"])
    model = CurveCloudNet(spec, n_points=inp["n_pad"],
                          feat_channels=(inp["in_dim"] - 3) or None)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in inp["state"].items()})
    return (model.to(device),
            to_device_batch(inp["batch"], "segmentation", device),
            LossConfig(**inp["loss"]))


def case_step(inp, device):
    """One train step of :func:`_model`'s model on its global batch
    through ``parallel.sharded_train_step`` (Adam at ``inp["lr"]``), with
    the generator ``inp["gen_seed"]`` (None: the deterministic sampling
    point) -> the loss, the gradients, buffers and parameters after the
    step."""
    from ..train.trainer import create_optimizer

    model, batch, loss_cfg = _model(inp, device)
    opt = create_optimizer(model)
    seed = inp.get("gen_seed")
    gen = (None if seed is None
           else torch.Generator(device=device).manual_seed(seed))
    metrics = parallel.sharded_train_step()(
        model.train(), opt, inp["lr"], batch, gen, 0.1, loss_cfg)
    return {"loss": metrics["loss"].cpu(),
            "grads": {k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None},
            "buffers": {k: b.cpu() for k, b in model.named_buffers()},
            "params": {k: p.detach().cpu()
                       for k, p in model.named_parameters()}}


def case_eval(inp, device):
    """:func:`_model`'s eval forward through ``parallel.sharded_eval_step``
    -> the global batch's logits, validity and loss."""
    model, batch, loss_cfg = _model(inp, device)
    logits, valid, loss = parallel.sharded_eval_step(model.eval(), batch,
                                                     loss_cfg)
    return {"logits": logits.cpu(), "valid": valid.cpu(), "loss": loss.cpu()}


CASES = {"bn": case_bn, "k7": case_k7, "k8": case_k8, "loss": case_loss,
         "rows": case_rows, "step": case_step, "eval": case_eval}


def run_cases(cases, device="cpu") -> dict:
    """``[(name, inputs), ...]`` -> ``{name: outputs}``; ``name`` is a
    key of :data:`CASES`, or ``key:label`` for a second case of a kind."""
    return {name: CASES[name.split(":")[0]](inp, torch.device(device))
            for name, inp in cases}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    device = torch.device(args.device)
    parallel.initialize_distributed(f"127.0.0.1:{args.port}", args.world,
                                    args.rank, device, timeout_s=120.0)
    try:
        cases = torch.load(args.inputs, weights_only=False)["cases"]
        torch.save(run_cases(cases, device), args.out.format(rank=args.rank))
    finally:
        parallel.shutdown()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "curvecloudnet_tpu"))
    if loaded:
        raise SystemExit(f"a rank process loaded {loaded}")


if __name__ == "__main__":
    main()
