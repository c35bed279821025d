"""Multi-process dry run of the data-parallel train step (counterpart of
``tools/multiproc_dryrun.py``).

Starts N local processes (a ``gloo`` group on 127.0.0.1, or ``nccl`` when
each has a card of its own) that jointly take ONE data-parallel step of
the nuScenes flagship at narrow widths: each process holds its own
synthetic sweeps (seed = its rank), the global batch is their
concatenation, and the step is ``train.trainer.train_step``.  Checks:

* every process joins the group and sees N processes;
* the step's loss is bit-identical on every process (the global batch's);
* ``parallel.process_shard_range`` hands every process the same number of
  items of a 10-item set, covering it.

Run from the repository root::

    python -m curvecloudnet_tpu_torch.tools.multiproc_dryrun [--procs 2] \\
        [--device cpu|cuda] [--n-pad 512] [--div 16] [--per-proc 2]

On one card every process takes ``cuda:0`` (gloo).  Prints one line.
"""

from __future__ import annotations

import argparse
import copy
import re
import sys

CONFIG = "configs/nuscenes.yaml"
MODULE = "curvecloudnet_tpu_torch.tools.multiproc_dryrun"


def shrink_feat_dims(model_cfg: dict, factor: int) -> dict:
    """The model block with every step's and the head's widths / factor
    (at least 8): the full step structure at narrow widths."""
    cfg = copy.deepcopy(model_cfg)
    for step in cfg["steps"]:
        step["feat_dims"] = [max(8, int(v) // factor)
                             for v in step["feat_dims"]]
    if isinstance(cfg.get("out_mlp"), dict) and "dims" in cfg["out_mlp"]:
        cfg["out_mlp"]["dims"] = [max(8, int(v) // factor)
                                  for v in cfg["out_mlp"]["dims"]]
    return cfg


def child(args) -> None:
    import torch

    from .. import parallel
    from ..config import load_config
    from ..models import CurveCloudNet, parse_model_config
    from ..predict import init_weights
    from ..run.tasks import loss_for
    from ..train.__main__ import synthetic_batch
    from ..train.trainer import create_optimizer, train_step

    device = parallel.local_device(torch.device(args.device), args.rank)
    if device.type == "cpu":
        torch.set_num_threads(2)
    parallel.initialize_distributed(f"127.0.0.1:{args.port}", args.procs,
                                    args.rank, torch.device(args.device))
    try:
        if parallel.process_count() != args.procs:
            raise AssertionError(f"{parallel.process_count()} processes")
        cfg = load_config(CONFIG)
        spec = parse_model_config(shrink_feat_dims(cfg["model"], args.div),
                                  in_dim=4, n_out=17)
        model = CurveCloudNet(spec, n_points=args.n_pad, feat_channels=1)
        init_weights(model, torch.Generator().manual_seed(0))
        model = model.to(device)
        batch = synthetic_batch(args.rank, args.n_pad, device,
                                batch=args.per_proc)
        gen = torch.Generator(device=device).manual_seed(0)
        out = train_step(model, create_optimizer(model), 5e-4, batch, gen,
                         0.1, loss_for(cfg))
        loss = float(out["loss"])
        if loss != loss:
            raise AssertionError("loss is not finite")
        shard = parallel.process_shard_range(10)
        print(f"MPCHILD rank={args.rank} loss={loss!r} shard={shard}",
              flush=True)
    finally:
        parallel.shutdown()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--n-pad", type=int, default=512)
    ap.add_argument("--div", type=int, default=16)
    ap.add_argument("--per-proc", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return child(args)

    from ..parallel import dryrun

    port = dryrun.free_port()
    common = ["--procs", str(args.procs), "--device", args.device,
              "--n-pad", str(args.n_pad), "--div", str(args.div),
              "--per-proc", str(args.per_proc), "--port", str(port)]
    outs = dryrun.spawn(lambda i: [sys.executable, "-m", MODULE, *common,
                                   "--rank", str(i)],
                        args.procs, args.timeout)
    infos = {}
    for out in outs:
        for line in out.splitlines():
            m = re.match(r"MPCHILD rank=(\d+) loss=(\S+) shard=(\[.*\])",
                         line)
            if m:
                infos[int(m.group(1))] = (m.group(2), [
                    int(v) for v in re.findall(r"\d+", m.group(3))])
    if len(infos) != args.procs:
        raise AssertionError(f"missing rank reports: {outs}")
    losses = {loss for loss, _ in infos.values()}
    if len(losses) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    shards = [infos[r][1] for r in sorted(infos)]
    if len({len(s) for s in shards}) != 1:
        raise AssertionError(f"unequal shards: {shards}")
    if set().union(*map(set, shards)) != set(range(10)):
        raise AssertionError(f"the shards miss items: {shards}")
    print(f"multiproc_dryrun ok: procs={args.procs} device={args.device} "
          f"loss={losses.pop()} shards={shards}")


if __name__ == "__main__":
    main()
