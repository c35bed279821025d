"""K2-bf16 of this checkout against another checkout's, in one process on
one card (GPU).

The other checkout (``--against DIR``: a source tree, for example the
parent commit unpacked with ``git archive <commit> | tar -x -C DIR``) is
imported under another name and builds its own kernels in ``DIR/build``,
so both wrappers run on the same recorded calls: the nuScenes flagship's
K2-bf16 calls of a ``compute_dtype: bfloat16`` scan (seed 0) and
shapenet-seg's at its batch (24).  For each call, in turns other, this,
this, other: kernel ms (CUDA events around the wrapper, median of 5),
device ms (``torch.profiler``, the kernel's own entries, 5 runs) and the
host's enqueue ms (the card idle before the call, median of 5); this
checkout's output is held against the plain version at 2^-8 of its scale
(seeds 1 and 2 too).  Then float32 K2 and K9 (the ``fused`` route) of a
float32 scan through both libraries, the same way.  Run from the
repository root::

    python -m curvecloudnet_tpu_torch.tools.k2_bf16_compare --against DIR

Prints a line per call and the totals.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

import torch
import yaml
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import predict as P
from ..config import load_config
from ..ops import edge_mlp, group_reduce as G

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOL = 2.0 ** -8


def load_other(root: str):
    """(group_reduce, edge_mlp) of the package in ``root``."""
    pkg = os.path.join(os.path.abspath(root), "curvecloudnet_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_ccn", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_ccn"] = mod
    spec.loader.exec_module(mod)
    from other_ccn.ops import edge_mlp as oe, group_reduce as og
    return og, oe


def bf16_config(name: str) -> str:
    """configs/<name>.yaml with its model block in bfloat16, under build/."""
    cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    cfg["model"]["compute_dtype"] = "bfloat16"
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    path = os.path.join(REPO, "build", f"k2cmp_{name}_bf16.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def recorded(module, name: str, run):
    """Run ``run()`` with ``module.name`` recording its calls -> the calls."""
    calls, fn = [], getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    # the wrapper counts its launches through its module-level name, which
    # is this stand-in while it is installed
    wrapped.launches = 0
    setattr(module, name, wrapped)
    try:
        with torch.inference_mode():
            run()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, fn)
    return calls


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def device_ms(fn, key: str, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and key in e.key
               ) / 1e3 / reps


def host_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2]


def held(out, ref, tol=TOL) -> float:
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    if not (bool(torch.isfinite(out).all()) and err <= tol * scale):
        raise AssertionError(f"max abs err {err} at scale {scale}")
    return err / scale


def compare(label, calls, other, this, key_other, key_this, ref=None,
            tol=TOL):
    totals = dict.fromkeys(("ko", "kt", "do", "dt"), 0.0)
    worst = 0.0
    for i, (args, kw) in enumerate(calls):
        with torch.inference_mode():
            if ref is not None:
                worst = max(worst, held(this(*args, **kw), ref(*args, **kw),
                                        tol))
            runs = {"o": ([], []), "t": ([], [])}
            for who in "otto":
                fn, key = ((lambda: other(*args, **kw)), key_other) \
                    if who == "o" else ((lambda: this(*args, **kw)), key_this)
                runs[who][0].append(cuda_ms(fn))
                runs[who][1].append(device_ms(fn, key))
            ho = host_ms(lambda: other(*args, **kw))
            ht = host_ms(lambda: this(*args, **kw))
        ko, do = (sum(v) / 2 for v in runs["o"])
        kt, dt = (sum(v) / 2 for v in runs["t"])
        print(f"{label} call {i} {tuple(args[0].shape)} "
              f"{kw.get('aggr', '')}: kernel ms other {ko:.4f} this "
              f"{kt:.4f}; device ms other {do:.4f} this {dt:.4f} (runs "
              f"{[round(x, 4) for x in runs['o'][1] + runs['t'][1]]}); "
              f"host enqueue ms other {ho:.3f} this {ht:.3f}", flush=True)
        for k, v in zip(("ko", "kt", "do", "dt"), (ko, kt, do, dt)):
            totals[k] += v
    print(f"{label} total, {len(calls)} calls: kernel ms other "
          f"{totals['ko']:.4f} this {totals['kt']:.4f}; device ms other "
          f"{totals['do']:.4f} this {totals['dt']:.4f}; worst err / scale "
          f"{worst:.3g}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="another checkout's root (its own kernels)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_bf16_compare: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    og, oe = load_other(args.against)
    # the other checkout's K2-bf16: its own kernel, or (before it had one)
    # the chain kernel it shared with float32 K2
    key_other = "group_wgmma_kernel" if os.path.exists(os.path.join(
        args.against, "curvecloudnet_tpu_torch", "csrc",
        "group_wgmma.cuh")) else "group_chain_kernel"
    n_pad = 36864
    nusc = os.path.join(REPO, "configs", "nuscenes.yaml")
    model = P.build_model(bf16_config("nuscenes"), n_pad, dev)
    for seed in (0, 1, 2):
        scan = P.synthetic_scan(seed, n_pad, dev)
        calls = recorded(G, "group_reduce_bf16",
                         lambda: P.predict(model, *scan))
        if seed == 0:
            compare("nuScenes bf16 K2-bf16", calls, og.group_reduce_bf16,
                    G.group_reduce_bf16, key_other, "group_wgmma_kernel",
                    G.group_reduce_ref)
            continue
        with torch.inference_mode():
            for a, kw in calls:
                held(G.group_reduce_bf16(*a, **kw), G.group_reduce_ref(*a,
                                                                       **kw))
        print(f"nuScenes bf16 seed {seed}: {len(calls)} K2-bf16 calls "
              "within 2^-8", flush=True)
    del model
    seg = bf16_config("shapenet-seg")
    seg_pad = P.n_pad_of(seg)
    obj = P.build_model(seg, seg_pad, dev)
    inputs = P.synthetic_inputs(seg, 0, seg_pad, dev)
    compare("shapenet-seg bf16 K2-bf16",
            recorded(G, "group_reduce_bf16",
                     lambda: P.predict(obj, *inputs)),
            og.group_reduce_bf16, G.group_reduce_bf16, key_other,
            "group_wgmma_kernel", G.group_reduce_ref)
    del obj
    model = P.build_model(nusc, n_pad, dev)
    scan = P.synthetic_scan(0, n_pad, dev)
    compare("nuScenes f32 K2",
            recorded(G, "group_reduce", lambda: P.predict(model, *scan)),
            og.group_reduce, G.group_reduce, "group_chain_kernel",
            "group_chain_kernel", G.group_reduce_ref, tol=1e-4)
    fused = P.build_model(nusc, n_pad, dev, edge_kernel="fused")
    compare("nuScenes f32 K9",
            recorded(edge_mlp, "fused_edge_mlp_max",
                     lambda: P.predict(fused, *scan)),
            oe.fused_edge_mlp_max, edge_mlp.fused_edge_mlp_max,
            "group_chain_kernel", "group_chain_kernel")


if __name__ == "__main__":
    main()
