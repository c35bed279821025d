"""K2-bf16 (or K7-bf16, K11, K8-bf16 t, K1-bf16, K4b-bf16: ``--kernel``)
of this checkout against another checkout's, in one process on one card
(GPU).

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
float32 scan through both libraries, the same way.

``--kernel k7``: the K7-bf16 calls of one nuScenes flagship train step in
``compute_dtype: bfloat16`` (seed 0) and of shapenet-seg's at its batch
(24), forward and backward, in turns as above (device ms: the call's K7
kernels, and everything it launches); beside each, its bound
(``chip_smoke.work``) and the cuBLAS bfloat16 ``torch.matmul`` of the
call's products alone (a yardstick, never on the path); both checkouts'
outputs held at phase 21's tolerances (the forward within 2^-8 of each
output's largest value against the contract with exact (float64) sums,
the backward within 2^-7 in relative L2 plus twice the plain version's
own bf16-vs-f32 change against plain; only this checkout's fail the
run), the forward's reading against the plain version, and plain's
against the exact sums, printed beside it; the nuScenes calls of seeds 1
and 2 too, under seed 0's weights (phase 21's setting) and under their
own.  Then the float32 K7 calls of a float32 step through both
libraries.

``--kernel k11``: K11 (the simulator's z-buffer) on the generator's 28
calls (phase 23's settings), the box and a ~10^5-face sphere at 2048,
kernel and device ms in turns, bit for bit against the plain version and
the other checkout's.  ``--kernel k8t``: K8-bf16's t pass on a nuScenes
bfloat16 step's three calls, kernel and device ms in turns, held at phase
21's 2^-7, two runs bit-identical, bit for bit against the other
checkout's, the float32 t pass beside it.
``--kernel k1b``: K1-bf16 on the nuScenes bfloat16 scans' step_31 calls
(seeds 0-2), ``--kernel k4bb``: K4b-bf16 on a nuScenes bfloat16 step's
calls, ``--kernel k8f``: K8-bf16's forward on a nuScenes bfloat16 step's
three calls (``k8t_calls``), ``--kernel k9``: K9-bf16 on the nuScenes
bfloat16 ``fused`` scans' calls and float32 K9 on float32 ``fused``
scans' (seeds 0-2 each); each in turns (other, this, this, other), kernel ms and device ms
(CUDA events on a pre-filled stream, ``chip_smoke.device_span_ms``: every
launch of the call, a zero fill included), the float32 twin on the same
inputs (this checkout), the bound; K1-bf16 held at phase 20's bound (one
bfloat16 ulp at the output's scale, under 1% of the elements differing),
K4b-bf16 at phase 21's (2^-8), two runs bit-identical and equal bit for
bit to its CPU model (``gather.scatter_km_table``); K8-bf16's forward at
phase 21's 2^-8, two runs bit-identical, beside the float32 forward on
the same inputs; K9 at phase 13's 1e-4 against the plain version, K9-bf16
bit for bit equal to float32 K9 on the widened rows, each call's device
ms split by ``torch.profiler`` into the projection (kernels named
``edge_project``), the chain and the rest (weight packs).  Run from the
repository root::

    python -m curvecloudnet_tpu_torch.tools.k2_bf16_compare --against DIR [--kernel k7|k11|k8t|k1b|k4bb|k8f|k9]

Prints a line per call and the totals.
"""

from __future__ import annotations

import argparse
import contextlib
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
from ..ops import edge_mlp, group_reduce as G, group_train as GT

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOL = 2.0 ** -8


def load_other(root: str):
    """(group_reduce, edge_mlp, group_train) of the package in ``root``;
    its other modules import as ``other_ccn.<name>``."""
    pkg = os.path.join(os.path.abspath(root), "curvecloudnet_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_ccn", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_ccn"] = mod
    spec.loader.exec_module(mod)
    from other_ccn.ops import edge_mlp as oe, group_reduce as og
    from other_ccn.ops import group_train as ot
    return og, oe, ot


def smoke():
    """The repository's ``chip_smoke`` module: its ``work`` (the bytes and
    operations a kernel's function must move and do) and peak rates."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


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


def device_ms(fn, key, reps: int = 5) -> float:
    """Device ms a run of ``fn`` in kernels whose names hold ``key`` (or
    any of a tuple of keys)."""
    keys = (key,) if isinstance(key, str) else key
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(k in e.key for k in keys)) / 1e3 / reps


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


def same(a, b) -> bool:
    """Whether two outputs (tensors, or nested tuples of them) are equal
    bit for bit."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape and bool(
            torch.equal(a, b))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def compare(label, calls, other, this, key_other, key_this, ref=None,
            tol=TOL):
    totals = dict.fromkeys(("ko", "kt", "do", "dt"), 0.0)
    worst = 0.0
    equal = 0
    for i, (args, kw) in enumerate(calls):
        with torch.inference_mode():
            equal += same(other(*args, **kw), this(*args, **kw))
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
          f"{worst:.3g}; outputs bit-identical at {equal} of {len(calls)} "
          "calls", flush=True)


def k7_calls(config: str, seed: int, dev, bf16: bool = True,
             weights: int = 0):
    """The K7 calls of one train step of ``config`` (the weights and draws
    of seed ``weights``, the synthetic batch of ``seed``; phase 21 of
    ``chip_smoke.py`` takes seed 0's weights): [(forward args, backward's
    dout)], the backward paired to its forward by h1."""
    from ..train.__main__ import setup, train_batch
    from ..train.trainer import train_step

    model, opt, _, loss_cfg, batch, gen = setup(config, dev, weights)
    if seed != weights:
        batch = train_batch(config, seed, P.n_pad_of(config), dev)
    names = (("group_train_fwd_bf16", "group_train_bwd_bf16") if bf16
             else ("group_train_fwd", "group_train_bwd"))
    calls = {n: [] for n in names}
    saved = {n: getattr(GT, n) for n in names}

    def recorder(name):
        def wrapped(*args, **kwargs):
            calls[name].append(args)
            return saved[name](*args, **kwargs)
        wrapped.launches = 0
        return wrapped

    for n in names:
        setattr(GT, n, recorder(n))
    try:
        train_step(model, opt, 0.0, batch, gen, 0.1, loss_cfg)
        torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(GT, n, fn)
    douts = {(a[0].data_ptr(), tuple(a[0].shape)): a[7]
             for a in calls[names[1]]}
    return [(a, douts[(a[0].data_ptr(), tuple(a[0].shape))])
            for a in calls[names[0]]]


def _shares(got, want, scale_of=None):
    """max |got - want| over ``TOL`` x max |scale_of| (``want`` by default);
    inf where got is not finite."""
    got, want = got.double(), want.double()
    ref = want if scale_of is None else scale_of.double()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    if not got.numel():
        return 0.0
    bound = TOL * float(ref.abs().max())
    err = float((got - want).abs().max())
    return err / bound if bound else (0.0 if err == 0 else float("inf"))


@contextlib.contextmanager
def exact_sums():
    """The plain K7 version with float64 sums: the contract's operands
    rounded to bfloat16 and their products summed in float64, each BN's
    statistics summed in float64 (its E[x^2] - mean^2 free of float32's
    cancellation), each rounded to float32 once."""
    mm, stats = GT._mm, GT._masked_stats

    def mm64(a, w, bf):
        return (GT._rnd(a, bf).double() @ GT._rnd(w, bf).double()).float()

    def stats64(v, mk, n):
        return tuple(t.float() for t in stats(v.double(), mk.double(),
                                              n.double()))

    GT._mm, GT._masked_stats = mm64, stats64
    try:
        yield
    finally:
        GT._mm, GT._masked_stats = mm, stats


@torch.no_grad()
def k7_held(args, dout, mod=GT) -> dict:
    """A K7-bf16 call of ``mod`` (this checkout's group_train, or the other
    checkout's) against the plain version at phase 21's tolerances -> the
    worst error of each kind as a share of its bound: "fwd" (the output's
    live rows and each BN's statistics within 2^-8 of their largest plain
    value), "bwd" (each gradient within 2^-7 in relative L2 plus twice the
    plain version's own bf16-vs-f32 change), and the forward's outputs
    against the contract with exact sums (:func:`exact_sums`; the same
    2^-8 of its largest value): at the worst output ("what"),
    "kernel_f64" and "plain_f64", over every output, "kernel_f64_all" and
    "plain_f64_all"."""
    h1, mask, cfg, params = args
    out, stats, n, extras = mod.group_train_fwd(*args)
    d_h1, grads = mod.group_train_bwd(h1, mask, cfg, params, stats, n,
                                      extras, dout)
    r_out, r_stats, r_n, r_ex = GT.group_train_fwd_ref(*args)
    with exact_sums():
        x_out, x_stats, _, _ = GT.group_train_fwd_ref(*args)
    rows = mask.any(-1)

    def outputs(o, st):
        return [o[rows]] + [t for mv in st for t in mv]

    got, want, exact = (outputs(out, stats), outputs(r_out, r_stats),
                        outputs(x_out, x_stats))
    names = ["out"] + [f"BN {i} {w}" for i in range(len(stats))
                       for w in ("mean", "var")]
    fwd = [_shares(g, w) for g, w in zip(got, want)]
    at = max(range(len(fwd)), key=fwd.__getitem__)
    # the worst output against plain, and each against the exact sums
    # (the output, then the statistics alone: plain's float32 statistics
    # against float64 sums say whether plain's own error sets a reading)
    res = {"fwd": fwd[at], "what": names[at],
           "kernel_f64": _shares(got[at], exact[at]),
           "plain_f64": _shares(want[at], exact[at]),
           "kernel_f64_all": max(_shares(g, x) for g, x in zip(got, exact)),
           "plain_f64_all": max(_shares(w, x) for w, x in zip(want, exact)),
           "plain_stats_f64": max((_shares(w, x) for w, x in zip(
               want[1:], exact[1:])), default=0.0)}
    r_h1, r_grads = GT.group_train_bwd_ref(h1, mask, cfg, params, r_stats,
                                           r_n, r_ex, dout)
    h32 = h1.float()
    _, s32, n32, e32 = GT.group_train_fwd_ref(h32, mask, cfg, params)
    f_h1, f_grads = GT.group_train_bwd_ref(h32, mask, cfg, params, s32, n32,
                                           e32, dout)
    outs = [(g.float(), w.float(), w32.float()) for g, w, w32 in zip(
        (d_h1,) + tuple(grads), (r_h1,) + tuple(r_grads),
        (f_h1,) + tuple(f_grads))]
    floor = TOL * max(float(w.norm()) for _, w, _ in outs)
    res["bwd"] = 0.0
    for g, w, w32 in outs:
        scale = max(float(w.norm()), floor)
        rel = float((g - w).norm()) / scale
        bound = 2 * TOL + 2 * float((w - w32).norm()) / scale
        res["bwd"] = max(res["bwd"], rel / bound if bool(
            torch.isfinite(g).all()) else float("inf"))
    return res


def k7_hold(label, calls, other) -> bool:
    """Hold this checkout's K7-bf16 calls and read the other checkout's the
    same way -> whether this checkout's are within their bounds.  The
    forward is held against the contract with exact (float64) sums, at
    the same 2^-8 of each output's largest value: plain's own float32
    error reaches that bound at seed 1 under its own weights (1.001 of it
    against the float64 sums, where the kernel reads 0.122), so a reading
    against plain measures plain's error as much as the kernel's.  The
    reading against plain, and plain's (statistics alone too) against the
    float64 sums, are printed beside it."""
    this = [k7_held(a, d) for a, d in calls]
    them = [k7_held(a, d, other) for a, d in calls]

    def worst(runs, key):
        return max(r[key] for r in runs)

    at = max(range(len(calls)), key=lambda i: this[i]["fwd"])
    at_them = max(range(len(calls)), key=lambda i: them[i]["fwd"])
    w = this[at]
    print(f"{label}: {len(calls)} K7-bf16 calls, worst error "
          f"{max(worst(this, 'kernel_f64_all'), worst(this, 'bwd')):.4g} of "
          f"its bound (fwd against the float64 contract "
          f"{worst(this, 'kernel_f64_all'):.4g}; bwd "
          f"{worst(this, 'bwd'):.4g}); against "
          f"plain fwd {w['fwd']:.4g} at call {at}'s {w['what']}, where "
          f"against exact sums this {w['kernel_f64']:.4g}, plain "
          f"{w['plain_f64']:.4g}; every forward output against exact sums: "
          f"this {worst(this, 'kernel_f64_all'):.4g}, plain "
          f"{worst(this, 'plain_f64_all'):.4g} (plain's statistics alone "
          f"{worst(this, 'plain_stats_f64'):.4g}); the other checkout: fwd "
          f"{worst(them, 'fwd'):.4g} at call {at_them}'s "
          f"{them[at_them]['what']}, bwd {worst(them, 'bwd'):.4g}, every "
          f"output against exact sums {worst(them, 'kernel_f64_all'):.4g}",
          flush=True)
    return max(worst(this, "kernel_f64_all"), worst(this, "bwd")) <= 1


@torch.no_grad()
def k7_products_ms(args) -> float:
    """cuBLAS bfloat16 ``torch.matmul`` of the call's products alone, forward
    and backward (each dense's, its data and weight gradient's), on random
    operands of their shapes: a yardstick."""
    h1, mask, cfg = args[:3]
    r = int(mask.sum())
    shapes = list(zip(cfg.dims[:-1], cfg.dims[1:]))
    if cfg.attend:
        shapes += [(cfg.dims[-1], cfg.att_dim), (cfg.att_dim, cfg.dims[-1])]
    ops = []
    for k, n in shapes:
        x = torch.randn(r, k, device=h1.device, dtype=torch.bfloat16)
        w = torch.randn(k, n, device=h1.device, dtype=torch.bfloat16)
        d = torch.randn(r, n, device=h1.device, dtype=torch.bfloat16)
        ops += [(x, w), (d, w.t()), (x.t(), d)]
    return cuda_ms(lambda: [a @ b for a, b in ops])


@torch.no_grad()
def k7_compare(label, calls, other, this, bf16=True):
    """K7's calls, the other checkout's wrappers against this one's, in
    turns (other, this, this, other): kernel ms, device ms (the K7
    kernels; everything launched), forward and backward apart."""
    S = smoke()
    names = (("group_train_fwd_bf16", "group_train_bwd_bf16") if bf16
             else ("group_train_fwd", "group_train_bwd"))
    this_fwd, this_bwd = (getattr(this, n) for n in names)
    keys = ("gt_gemm", "gt_finalize", "gt_rowstats", "gt_aggregate", "gtw_")
    tot = {"equal": 0}
    for i, (args, dout) in enumerate(calls):
        h1, mask, cfg, params = args
        line = []
        for d in ("fwd", "bwd"):
            runs = {"o": [], "t": []}
            for who in "otto":
                mod = other if who == "o" else this
                fwd, bwd = (getattr(mod, n) for n in names)
                if d == "fwd":
                    fn = (lambda fwd=fwd: fwd(*args))
                else:
                    _, st, n, ex = fwd(*args)
                    fn = (lambda bwd=bwd, st=st, n=n, ex=ex: bwd(
                        h1, mask, cfg, params, st, n, ex, dout))
                with torch.no_grad():
                    runs[who].append((cuda_ms(fn), device_ms(fn, keys),
                                      device_ms(fn, ("",))))
            vals = {w: [sum(x[j] for x in v) / 2 for j in range(3)]
                    for w, v in runs.items()}
            if d == "fwd":
                res = this_fwd(*args)
                byts, flops = S.work(names[0], args, res)
            else:
                _, st, n, ex = this_fwd(*args)
                b_args = (h1, mask, cfg, params, st, n, ex, dout)
                byts, flops = S.work(names[1], b_args, this_bwd(*b_args))
            peak = S.OPS_PEAK.get(names[0], S.PEAK_FP32)
            bound = max(byts / S.PEAK_BYTES, flops / peak) * 1e3
            for w in "ot":
                for j, key in enumerate(("kernel", "device", "all")):
                    k = (d, w, key)
                    tot[k] = tot.get(k, 0.0) + vals[w][j]
            tot[(d, "bound")] = tot.get((d, "bound"), 0.0) + bound
            line.append(
                f"{d}: kernel ms other {vals['o'][0]:.3f} this "
                f"{vals['t'][0]:.3f}; device ms (K7 kernels) other "
                f"{vals['o'][1]:.3f} this {vals['t'][1]:.3f}, (all) other "
                f"{vals['o'][2]:.3f} this {vals['t'][2]:.3f}; bound "
                f"{bound:.4f} ({bound / vals['t'][1]:.1%} of this device "
                f"ms)")
        if not bf16:   # float32 K7 is the same kernel in both trees
            fo, bo = (getattr(other, n) for n in names)
            ft, bt = (getattr(this, n) for n in names)
            ro, rt = fo(*args), ft(*args)
            tot["equal"] += same(ro[:3], rt[:3]) and same(
                bo(h1, mask, cfg, params, *ro[1:], dout),
                bt(h1, mask, cfg, params, *rt[1:], dout))
        cub = k7_products_ms(args) if bf16 else float("nan")
        tot["cublas"] = tot.get("cublas", 0.0) + cub
        print(f"{label} call {i} widths {list(cfg.dims)} attend "
              f"{cfg.att_dim} K {h1.shape[1]} M {h1.shape[2]} live rows "
              f"{int(mask.sum())}: " + "; ".join(line)
              + f"; cuBLAS products ms {cub:.3f}", flush=True)
    for d in ("fwd", "bwd"):
        print(f"{label} {d} total, {len(calls)} calls: kernel ms other "
              f"{tot[(d, 'o', 'kernel')]:.3f} this "
              f"{tot[(d, 't', 'kernel')]:.3f}; device ms (K7 kernels) "
              f"other {tot[(d, 'o', 'device')]:.3f} this "
              f"{tot[(d, 't', 'device')]:.3f}; (all) other "
              f"{tot[(d, 'o', 'all')]:.3f} this {tot[(d, 't', 'all')]:.3f};"
              f" bound {tot[(d, 'bound')]:.4f}", flush=True)
    print(f"{label} fwd + bwd device ms (K7 kernels): other "
          f"{tot[('fwd', 'o', 'device')] + tot[('bwd', 'o', 'device')]:.3f}"
          f" this {tot[('fwd', 't', 'device')] + tot[('bwd', 't', 'device')]:.3f}"
          f"; cuBLAS products {tot['cublas']:.3f}"
          + ("" if bf16 else f"; outputs and gradients bit-identical at "
             f"{tot['equal']} of {len(calls)} calls"), flush=True)


def main_k7(ot, dev) -> None:
    """``--kernel k7``: the K7 calls of the bfloat16 train steps (and the
    float32 step's), the other checkout's against this one's."""
    nusc = bf16_config("nuscenes")
    failed = []
    for seed in (0, 1, 2):
        for weights in sorted({0, seed}):
            label = f"nuScenes bf16 seed {seed} (seed {weights}'s weights)"
            calls = k7_calls(nusc, seed, dev, weights=weights)
            if not k7_hold(label, calls, ot):
                failed.append(label)
            if seed == 0:
                k7_compare("nuScenes bf16 K7-bf16", calls, ot, GT)
            del calls
    seg = k7_calls(bf16_config("shapenet-seg"), 0, dev)
    if not k7_hold("shapenet-seg bf16", seg, ot):
        failed.append("shapenet-seg bf16")
    k7_compare("shapenet-seg bf16 K7-bf16", seg, ot, GT)
    del seg
    k7_compare("nuScenes f32 K7", k7_calls(os.path.join(
        REPO, "configs", "nuscenes.yaml"), 0, dev, bf16=False), ot, GT,
        bf16=False)
    if failed:
        raise SystemExit(f"K7-bf16 past its bounds: {failed}")


def k11_calls(dev):
    """K11's calls: the generator's (phase 23's settings, ``GEN23`` of
    ``chip_smoke``: shapenet-seg's 24 scans and kortx's 4), then the box
    and a ~10^5-face sphere (``uv_sphere(224, 224)``) at 2048 -> [(label,
    (vertices, faces, pinhole) on the card)]."""
    from ..simulator import generate as SG
    from ..simulator import rasterizer as R

    S = smoke()
    out = []
    for label, name, n_scans, so3 in S.GEN23:
        gen = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))[
            "data_generation"]
        calls = recorded(R, "rasterize", lambda: SG.generate_dataset(
            os.path.join(REPO, "build", "k11cmp", label), n_samples=n_scans,
            n_points=gen["num_points"], resolution=gen["resolution"],
            pattern=gen["laser_motion"], density=gen["line_density"],
            random_so3=so3, seed=0, device=dev))
        out += [(label, a[:3]) for a, _ in calls]
    for name, mesh in (("box", SG.box()),
                       ("sphere 1e5", SG.uv_sphere(n_lat=224, n_lon=224))):
        verts, faces = mesh
        verts = verts - verts.mean(0)
        verts = verts / float(((verts ** 2).sum(1) ** 0.5).max())
        pin = R.Pinhole(1.8 * 2048, 1.8 * 2048, 1024.0, 1024.0, 2048, 2048)
        out.append((f"{name} at 2048 ({len(faces)} faces)",
                    (R.look_at_camera(verts, distance=2.2), faces, pin)))
    return [(label, (torch.as_tensor(v, dtype=torch.float32).to(dev),
                     torch.as_tensor(f).to(dev), pin))
            for label, (v, f, pin) in out]


@torch.no_grad()
def main_k11(root: str, dev) -> None:
    """``--kernel k11``: K11 of the other checkout against this one's on
    the generator's calls, the box and the dense sphere, in turns (other,
    this, this, other): kernel ms, device ms (every kernel and memset of
    the call), the bound; this checkout's output bit for bit against the
    plain version and the other checkout's."""
    import importlib

    from ..simulator import rasterizer as R

    O = importlib.import_module("other_ccn.simulator.rasterizer")
    S = smoke()
    failed = []
    tot = {}
    for i, (label, args) in enumerate(k11_calls(dev)):
        got = R.rasterize(*args, dev)
        diff = S.raster_diff(got, R.rasterize_plain(*args, dev))
        other = S.raster_diff(got, O.rasterize(*args, dev))
        if diff:
            failed.append(f"call {i} ({label}): {diff} pixels")
        runs = {"o": [], "t": []}
        for who in "otto":
            fn = ((lambda: O.rasterize(*args, dev)) if who == "o"
                  else (lambda: R.rasterize(*args, dev)))
            runs[who].append((cuda_ms(fn), device_ms(fn, ("",))))
        k = {w: [sum(x[j] for x in v) / 2 for j in range(2)]
             for w, v in runs.items()}
        bound = S.raster_bytes(args)[0] / S.PEAK_BYTES * 1e3
        group = "generator" if label.startswith("generate") else label
        for key, v in (("ko", k["o"][0]), ("kt", k["t"][0]),
                       ("do", k["o"][1]), ("dt", k["t"][1]),
                       ("bound", bound), ("n", 1)):
            tot[(group, key)] = tot.get((group, key), 0.0) + v
        print(f"K11 call {i} ({label}, {len(args[1])} faces, res "
              f"{args[2].h}): kernel ms other {k['o'][0]:.4f} this "
              f"{k['t'][0]:.4f}; device ms other {k['o'][1]:.4f} this "
              f"{k['t'][1]:.4f}; bound {bound:.4f} ms (bytes); pixels "
              f"differing from plain {diff}, from the other checkout "
              f"{other}", flush=True)
    for group in dict.fromkeys(g for g, _ in tot):
        t = {key: tot[(group, key)] for key in
             ("ko", "kt", "do", "dt", "bound", "n")}
        print(f"K11 {group}, {int(t['n'])} calls: kernel ms other "
              f"{t['ko']:.4f} this {t['kt']:.4f} ({t['kt'] / t['ko']:.3f}x);"
              f" device ms other {t['do']:.4f} this {t['dt']:.4f}; bound "
              f"{t['bound']:.4f} ms ({t['bound'] / t['dt']:.1%} of this "
              "device ms)", flush=True)
    if failed:
        raise SystemExit(f"K11 differs from its plain version: {failed}")


# K8's wrappers whose calls a step records: the bfloat16 t pass, and the
# passes this tree leaves as they were (the bfloat16 forward; step 0's
# float32 chain and the reduce)
K8_NAMES = ("conv1d_train_bwd_t_bf16", "conv1d_train_fwd_layer_bf16",
            "conv1d_train_fwd_layer", "conv1d_train_bwd_t",
            "conv1d_train_bwd_reduce")


def k8t_calls(config: str, dev):
    """K8's calls of one train step of ``config`` (seed 0's weights and
    batch, phase 21's) -> {wrapper: [(args, kwargs)]}; the float32
    wrappers' calls only where they run float32."""
    from ..ops import conv1d_train as C
    from ..train.__main__ import setup
    from ..train.trainer import train_step

    model, opt, _, loss_cfg, batch, gen = setup(config, dev, 0)
    calls = {n: [] for n in K8_NAMES}
    saved = {n: getattr(C, n) for n in K8_NAMES}

    def recorder(name):
        def wrapped(*args, **kwargs):
            if not (kwargs.get("bf16") or (len(args) > 6 and args[6] is True)
                    or (len(args) > 11 and args[11] is True)):
                calls[name].append((args, kwargs))
            return saved[name](*args, **kwargs)
        wrapped.launches = 0
        return wrapped

    for n in K8_NAMES:
        setattr(C, n, recorder(n))
    try:
        train_step(model, opt, 0.0, batch, gen, 0.1, loss_cfg)
        torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(C, n, fn)
    return calls


def main_k8t(dev) -> None:
    """``--kernel k8t``: the K8-bf16 t calls of a nuScenes bfloat16 step
    (step 31's three layers), the other checkout's wrapper against this
    one's in turns (other, this, this, other): kernel ms, device ms (every
    kernel of the call), the bound (``chip_smoke.work`` at the bfloat16
    rate); this checkout's held against the plain version at phase 21's
    tolerance (2^-7, ``chip_smoke.compare_bf16_train``), run twice bit for
    bit; the float32 t pass on the same inputs (this checkout) beside it;
    the step's other K8 calls (the bfloat16 forward, step 0's float32
    chain, the reduce) bit for bit against the other checkout's."""
    import importlib

    from ..ops import conv1d_train as C

    O = importlib.import_module("other_ccn.ops.conv1d_train")
    S = smoke()
    name = "conv1d_train_t_bf16"
    tot = dict.fromkeys(("ko", "kt", "do", "dt", "bound", "f32"), 0.0)
    recorded_calls = k8t_calls(bf16_config("nuscenes"), dev)
    calls = recorded_calls[K8_NAMES[0]]
    torch.set_grad_enabled(False)
    for wrapper in K8_NAMES[1:]:
        flat = lambda o: list(o[:3]) + list(o[3] if len(o) == 4 else ())  # noqa
        got = [(flat(getattr(C, wrapper)(*a, **k)),
                flat(getattr(O, wrapper)(*a, **k)))
               for a, k in recorded_calls[wrapper]]
        equal = sum(all(torch.equal(x, y) for x, y in zip(t, o))
                    for t, o in got)
        print(f"K8 {wrapper}: this tree's outputs bit-identical to the "
              f"other's at {equal} of {len(got)} calls", flush=True)
    for i, (args, kw) in enumerate(calls):
        out = C.conv1d_train_bwd_t_bf16(*args, **kw)
        err, _ = S.compare_bf16_train(name, args, kw, out,
                                      C.conv1d_train_bwd_t_ref, 2.0 ** -7)
        again = C.conv1d_train_bwd_t_bf16(*args, **kw)
        flat = lambda o: [*o[:3], *(o[3] if len(o) == 4 else ())]  # noqa
        repeat = all(torch.equal(a, b) for a, b in zip(flat(out),
                                                       flat(again)))
        if not repeat:
            raise SystemExit(f"K8-bf16 t call {i}: two runs differ")
        same = all(torch.equal(a, b) for a, b in zip(
            flat(out), flat(O.conv1d_train_bwd_t_bf16(*args, **kw))))
        runs = {"o": [], "t": []}
        for who in "otto":
            mod = O if who == "o" else C
            fn = (lambda mod=mod: mod.conv1d_train_bwd_t_bf16(*args, **kw))
            runs[who].append((cuda_ms(fn), device_ms(fn, ("",))))
        k = {w: [sum(x[j] for x in v) / 2 for j in range(2)]
             for w, v in runs.items()}
        f32 = device_ms(lambda: C.conv1d_train_bwd_t(
            args[0], args[1], args[2].float(), *args[3:], **kw), ("",))
        byts, flops = S.work(name, args, out)
        bound = max(byts / S.PEAK_BYTES, flops / S.PEAK_BF16) * 1e3
        for key, v in zip(("ko", "kt", "do", "dt", "bound", "f32"),
                          (k["o"][0], k["t"][0], k["o"][1], k["t"][1],
                           bound, f32)):
            tot[key] += v
        print(f"K8-bf16 t call {i} (input {tuple(args[2].shape)} "
              f"{args[2].dtype}, prev_sums {len(out) == 4}): "
              f"kernel ms other {k['o'][0]:.4f} this {k['t'][0]:.4f}; "
              f"device ms other {k['o'][1]:.4f} this {k['t'][1]:.4f}; "
              f"float32 t pass device ms {f32:.4f}; bound {bound:.4f} ms; "
              f"error {err:.3g} (2^-7 bound: relative L2 plus twice plain's "
              f"bf16-vs-f32 change); two runs bit-identical; equal to the "
              f"other checkout's bit for bit: {same}", flush=True)
    print(f"K8-bf16 t, a step's calls: kernel ms other {tot['ko']:.4f} "
          f"this {tot['kt']:.4f}; device ms other {tot['do']:.4f} this "
          f"{tot['dt']:.4f} ({tot['dt'] / tot['do']:.3f}x); float32 t pass "
          f"{tot['f32']:.4f}; bound {tot['bound']:.4f} ms "
          f"({tot['bound'] / tot['dt']:.1%} of this device ms)", flush=True)


def _turns(other, this, reps=5):
    """Kernel ms (events around the call) and device ms (events on a
    pre-filled stream) of two callables in turns (other, this, this,
    other) -> ((kernel other, this), (device other, this))."""
    S = smoke()
    runs = {"o": [], "t": []}
    for who in "otto":
        fn = other if who == "o" else this
        runs[who].append((cuda_ms(fn, reps), S.device_span_ms(fn, reps)))
    k = {w: [sum(x[j] for x in v) / 2 for j in range(2)]
         for w, v in runs.items()}
    return (k["o"][0], k["t"][0]), (k["o"][1], k["t"][1])


def main_k1b(dev) -> None:
    """``--kernel k1b``: the K1-bf16 calls of nuScenes bfloat16 scans
    (step_31, seeds 0-2), the other checkout's wrapper against this one's
    in turns; float32 K1 on the same inputs beside them; this checkout's
    output held against the plain version (one bfloat16 ulp at
    max(1, max |plain|), under 1% of the elements differing)."""
    import importlib

    from ..ops import conv1d_chain as C

    O = importlib.import_module("other_ccn.ops.conv1d_chain")
    S = smoke()
    n_pad = 36864
    model = P.build_model(bf16_config("nuscenes"), n_pad, dev)
    tot = dict.fromkeys(("ko", "kt", "do", "dt", "f32", "bound"), 0.0)
    n = 0
    for seed in (0, 1, 2):
        scan = P.synthetic_scan(seed, n_pad, dev)
        calls = recorded(C, "conv1d_chain_eval_bf16",
                         lambda: P.predict(model, *scan))
        with torch.inference_mode():
            for i, (a, kw) in enumerate(calls):
                out = C.conv1d_chain_eval_bf16(*a, **kw)
                ref = C.conv1d_chain_eval_ref(*a, **kw)
                diff = (out.float() - ref.float()).abs()
                scale = max(1.0, float(ref.float().abs().max()))
                share = float((diff > 0).float().mean())
                if not (float(diff.max()) <= S.bf16_ulp(scale)
                        and share < S.BF16_FLIP_SHARE):
                    raise SystemExit(f"K1-bf16 seed {seed} call {i}: max "
                                     f"err {float(diff.max())} at scale "
                                     f"{scale}, {share:.3%} differ")
                other = O.conv1d_chain_eval_bf16(*a, **kw)
                (ko, kt), (do, dt) = _turns(
                    lambda: O.conv1d_chain_eval_bf16(*a, **kw),
                    lambda: C.conv1d_chain_eval_bf16(*a, **kw))
                x32 = a[0].float()
                f32 = S.device_span_ms(
                    lambda: C.conv1d_chain_eval(x32, *a[1:], **kw), 5)
                same32 = torch.equal(C.conv1d_chain_eval(x32, *a[1:], **kw),
                                     O.conv1d_chain_eval(x32, *a[1:], **kw))
                byts, flops = S.work("conv1d_chain_bf16", a, out)
                bound = max(byts / S.PEAK_BYTES, flops / S.PEAK_BF16) * 1e3
                for key, v in zip(tot, (ko, kt, do, dt, f32, bound)):
                    tot[key] += v
                n += 1
                print(f"K1-bf16 seed {seed} call {i} (xe "
                      f"{tuple(a[0].shape)}, used {a[2].tolist()}): kernel "
                      f"ms other {ko:.4f} this {kt:.4f}; device ms other "
                      f"{do:.4f} this {dt:.4f} ({dt / do:.3f}x); float32 "
                      f"K1 device ms {f32:.4f}; bound {bound:.4f} ms "
                      f"({bound / dt:.1%}); error {float(diff.max()):.3g} "
                      f"at scale {scale:.3g}, {share:.3%} of elements "
                      f"differ from plain; {int((out != other).sum())} "
                      "differ from the other checkout's; float32 K1 on "
                      f"them bit-identical to the other's: {same32}",
                      flush=True)
    print(f"K1-bf16, {n} calls (a scan each): kernel ms other "
          f"{tot['ko'] / n:.4f} this {tot['kt'] / n:.4f}; device ms other "
          f"{tot['do'] / n:.4f} this {tot['dt'] / n:.4f} a scan "
          f"({tot['dt'] / tot['do']:.3f}x); float32 K1 "
          f"{tot['f32'] / n:.4f}; bound {tot['bound'] / n:.4f} ms",
          flush=True)


def main_k4bb(dev) -> None:
    """``--kernel k4bb``: the K4b-bf16 calls of a nuScenes bfloat16 train
    step (seed 0), the other checkout's wrapper against this one's in
    turns; float32 K4b on the same inputs beside them; this checkout's
    output held against the plain version at phase 21's 2^-8, run twice
    bit for bit and equal to its CPU model (the inverse table's order)."""
    import importlib

    from ..ops import gather as K
    from ..train.__main__ import setup
    from ..train.trainer import train_step

    O = importlib.import_module("other_ccn.ops.gather")
    S = smoke()
    model, opt, _, loss_cfg, batch, gen = setup(bf16_config("nuscenes"), dev,
                                                0)
    calls, fwd = [], []
    fn, gfn = K.scatter_km_bf16, K.gather_km_bf16

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    def gathered(*args, **kwargs):
        fwd.append((args, kwargs))
        return gfn(*args, **kwargs)

    wrapped.launches = gathered.launches = 0
    K.scatter_km_bf16, K.gather_km_bf16 = wrapped, gathered
    try:
        train_step(model, opt, 0.0, batch, gen, 0.1, loss_cfg)
        torch.cuda.synchronize()
    finally:
        K.scatter_km_bf16, K.gather_km_bf16 = fn, gfn
    tot = dict.fromkeys(("ko", "kt", "do", "dt", "f32", "bound"), 0.0)
    torch.set_grad_enabled(False)
    equal = sum(torch.equal(K.gather_km_bf16(*a, **kw),
                            O.gather_km_bf16(*a, **kw)) for a, kw in fwd)
    print(f"K4-bf16 (the step's forward gathers): this tree's outputs "
          f"bit-identical to the other's at {equal} of {len(fwd)} calls",
          flush=True)
    for i, (a, kw) in enumerate(calls):
        out = K.scatter_km_bf16(*a, **kw)
        err = S._bf16_max("scatter_bf16", out, K.scatter_km_ref(*a, **kw),
                          2.0 ** -8)
        if not torch.equal(out, K.scatter_km_bf16(*a, **kw)):
            raise SystemExit(f"K4b-bf16 call {i}: two runs differ")
        model_out = K.scatter_km_table(a[0].cpu(), a[1].cpu(), *a[2:], **kw)
        if not torch.equal(out.cpu(), model_out):
            raise SystemExit(f"K4b-bf16 call {i}: not the CPU model's sums")
        (ko, kt), (do, dt) = _turns(lambda: O.scatter_km_bf16(*a, **kw),
                                    lambda: K.scatter_km_bf16(*a, **kw))
        d32 = a[0].float()
        f32 = S.device_span_ms(lambda: K.scatter_km(d32, *a[1:], **kw), 5)
        byts, _ = S.work("scatter_bf16", a, out)
        bound = byts / S.PEAK_BYTES * 1e3
        for key, v in zip(tot, (ko, kt, do, dt, f32, bound)):
            tot[key] += v
        print(f"K4b-bf16 call {i} (d_out {tuple(a[0].shape)}, n {a[2]}): "
              f"kernel ms other {ko:.4f} this {kt:.4f}; device ms other "
              f"{do:.4f} this {dt:.4f}; float32 K4b device ms {f32:.4f}; "
              f"bound {bound:.4f} ms; error {err:.3g}; two runs "
              "bit-identical, equal to the CPU model", flush=True)
    print(f"K4b-bf16, a step's {len(calls)} calls: kernel ms other "
          f"{tot['ko']:.4f} this {tot['kt']:.4f}; device ms other "
          f"{tot['do']:.4f} this {tot['dt']:.4f} ({tot['dt'] / tot['do']:.3f}"
          f"x); float32 K4b {tot['f32']:.4f}; bound {tot['bound']:.4f} ms "
          f"({tot['bound'] / tot['dt']:.1%} of this device ms)", flush=True)


def main_k8f(dev) -> None:
    """``--kernel k8f``: the K8-bf16 forward calls of a nuScenes bfloat16
    step (step 31's three layers), the other checkout's wrapper against
    this one's in turns (other, this, this, other): kernel ms, device ms
    (events on a pre-filled stream: every launch of the call), the bound
    (``chip_smoke.work`` at the bfloat16 rate); this checkout's (z, mean,
    var) held against the plain version at phase 21's 2^-8, run twice bit
    for bit; the float32 forward on the same inputs (this checkout)
    beside it."""
    import importlib

    from ..ops import conv1d_train as C

    O = importlib.import_module("other_ccn.ops.conv1d_train")
    S = smoke()
    name = "conv1d_train_fwd_bf16"
    calls = k8t_calls(bf16_config("nuscenes"), dev)[K8_NAMES[1]]
    tot = dict.fromkeys(("ko", "kt", "do", "dt", "f32", "bound"), 0.0)
    torch.set_grad_enabled(False)
    for i, (a, kw) in enumerate(calls):
        out = C.conv1d_train_fwd_layer_bf16(*a, **kw)
        ref = C.conv1d_train_fwd_layer_ref(*a, **kw, bf16=True)
        err = max(S._bf16_max(name, o, r, 2.0 ** -8)
                  for o, r in zip(out, ref))
        if not all(torch.equal(x, y) for x, y in zip(
                out, C.conv1d_train_fwd_layer_bf16(*a, **kw))):
            raise SystemExit(f"K8-bf16 fwd call {i}: two runs differ")
        other = O.conv1d_train_fwd_layer_bf16(*a, **kw)
        (ko, kt), (do, dt) = _turns(
            lambda: O.conv1d_train_fwd_layer_bf16(*a, **kw),
            lambda: C.conv1d_train_fwd_layer_bf16(*a, **kw))
        a32 = (a[0].float(), *a[1:])
        f32 = S.device_span_ms(lambda: C.conv1d_train_fwd_layer(*a32, **kw),
                               5)
        byts, flops = S.work(name, a, out)
        bound = max(byts / S.PEAK_BYTES, flops / S.PEAK_BF16) * 1e3
        for key, v in zip(tot, (ko, kt, do, dt, f32, bound)):
            tot[key] += v
        zd = int((out[0] != other[0]).sum())
        this = lambda: C.conv1d_train_fwd_layer_bf16(*a, **kw)  # noqa: E731
        split = {k: device_ms(this, k) for k in ("pack", "fwd_bf16_kernel",
                                                 "moments")}
        print(f"K8-bf16 fwd call {i} (input {tuple(a[0].shape)} "
              f"{a[0].dtype}, previous BN {a[1] is not None}): kernel ms "
              f"other {ko:.4f} this {kt:.4f}; device ms other {do:.4f} "
              f"this {dt:.4f} ({dt / do:.3f}x; by kernel, profiler: "
              f"{ {k: round(v, 4) for k, v in split.items()} }); float32 "
              f"forward device ms {f32:.4f}; bound {bound:.4f} ms "
              f"({bound / dt:.1%}); error "
              f"{err:.3g} (2^-8 of the largest); {zd} z elements differ "
              "from the other checkout's; two runs bit-identical",
              flush=True)
    print(f"K8-bf16 fwd, a step's {len(calls)} calls: kernel ms other "
          f"{tot['ko']:.4f} this {tot['kt']:.4f}; device ms other "
          f"{tot['do']:.4f} this {tot['dt']:.4f} ({tot['dt'] / tot['do']:.3f}"
          f"x); float32 forward {tot['f32']:.4f}; bound {tot['bound']:.4f} "
          f"ms ({tot['bound'] / tot['dt']:.1%} of this device ms)",
          flush=True)


# K9's kernels by name: the projection, the chain (K2's shared body), the
# rest (weight packs)
K9_PROJECT = "edge_project"
K9_CHAIN = ("group_chain_kernel",)
K9_KEYS = (K9_PROJECT,) + K9_CHAIN + ("edge_pack",)
K9_TOL = 1e-4  # phase 13's bound, relative to the largest value not -100


def k9_split(fn) -> tuple:
    """(projection, chain, rest) device ms of a K9 call by
    ``torch.profiler`` (a fresh process reads every record)."""
    proj = device_ms(fn, K9_PROJECT)
    chain = device_ms(fn, K9_CHAIN)
    return proj, chain, max(0.0, device_ms(fn, ("",)) - proj - chain)


def main_k9(dev) -> None:
    """``--kernel k9``: K9-bf16's calls of nuScenes bfloat16 ``fused``
    scans and float32 K9's of float32 ``fused`` scans (seeds 0-2 each),
    the other checkout's wrapper against this one's in turns: kernel
    ms, device ms (events on a pre-filled stream), each call's split into
    the projection, the chain and the rest (profiler), the bound
    (``chip_smoke.work``); this checkout's output held against the plain
    version at phase 13's 1e-4, K9-bf16's equal bit for bit to float32
    K9 on the widened rows."""
    S = smoke()
    O = sys.modules["other_ccn.ops.edge_mlp"]
    n_pad = 36864
    cases = [("bf16", bf16_config("nuscenes"), seed) for seed in (0, 1, 2)]
    cases += [("f32", os.path.join(REPO, "configs", "nuscenes.yaml"), seed)
              for seed in (0, 1, 2)]
    for dtype, config, seed in cases:
        model = P.build_model(config, n_pad, dev, edge_kernel="fused")
        scan = P.synthetic_scan(seed, n_pad, dev)
        wrapper = ("fused_edge_mlp_max_bf16" if dtype == "bf16"
                   else "fused_edge_mlp_max")
        calls = recorded(edge_mlp, wrapper, lambda: P.predict(model, *scan))
        del model
        tot = dict.fromkeys(("ko", "kt", "do", "dt", "pt", "ct", "po", "co",
                             "bound"), 0.0)
        with torch.inference_mode():
            for i, (a, kw) in enumerate(calls):
                this = lambda: edge_mlp._launch(*a, **kw)  # noqa: E731
                other = lambda: O._launch(*a, **kw)  # noqa: E731
                out = this()
                err = S.compare("edge_mlp", out,
                                edge_mlp.fused_edge_mlp_max_ref(*a, **kw),
                                K9_TOL)
                widened = ""
                if dtype == "bf16":
                    f32 = edge_mlp._launch(a[0].float(), *a[1:], **kw)
                    if not torch.equal(out, f32):
                        raise SystemExit(f"K9-bf16 seed {seed} call {i}: "
                                         "not float32 K9's on the widened "
                                         "rows")
                    widened = "; equal to float32 K9 on the widened rows"
                (ko, kt), (do, dt) = _turns(other, this)
                po, co, ro = k9_split(other)
                pt, ct, rt = k9_split(this)
                byts, flops = S.work("edge_mlp", a, out)
                bound = max(byts / S.PEAK_BYTES,
                            flops / S.OPS_PEAK["edge_mlp"]) * 1e3
                for key, v in zip(tot, (ko, kt, do, dt, pt, ct, po, co,
                                        bound)):
                    tot[key] += v
                k = a[1].shape[-1]
                widths = [w.shape[1] for w in a[2]]
                print(f"K9 {dtype} seed {seed} call {i} (x "
                      f"{tuple(a[0].shape)}, k {k}, widths {widths}, live "
                      f"edges {int((a[1] >= 0).sum())}): kernel ms other "
                      f"{ko:.4f} this {kt:.4f}; device ms other {do:.4f} "
                      f"this {dt:.4f} ({dt / do:.3f}x); profiler split "
                      f"other projection {po:.4f} chain {co:.4f} rest "
                      f"{ro:.4f}, this projection {pt:.4f} chain {ct:.4f} "
                      f"rest {rt:.4f}; bound {bound:.4f} ms "
                      f"({bound / dt:.1%}); error {err:.3g}{widened}",
                      flush=True)
        print(f"K9 {dtype} seed {seed}, a scan's {len(calls)} calls: kernel "
              f"ms other {tot['ko']:.4f} this {tot['kt']:.4f}; device ms "
              f"other {tot['do']:.4f} this {tot['dt']:.4f} "
              f"({tot['dt'] / tot['do']:.3f}x); projection other "
              f"{tot['po']:.4f} this {tot['pt']:.4f}; chain other "
              f"{tot['co']:.4f} this {tot['ct']:.4f}; bound "
              f"{tot['bound']:.4f} ms", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="another checkout's root (its own kernels)")
    ap.add_argument("--kernel", default="k2",
                    choices=("k2", "k7", "k11", "k8t", "k1b", "k4bb", "k8f",
                             "k9"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_bf16_compare: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    og, oe, ot = load_other(args.against)
    if args.kernel == "k7":
        main_k7(ot, dev)
        return
    if args.kernel == "k11":
        main_k11(args.against, dev)
        return
    if args.kernel == "k8t":
        main_k8t(dev)
        return
    if args.kernel == "k1b":
        main_k1b(dev)
        return
    if args.kernel == "k4bb":
        main_k4bb(dev)
        return
    if args.kernel == "k8f":
        main_k8f(dev)
        return
    if args.kernel == "k9":
        main_k9(dev)
        return
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
            oe.fused_edge_mlp_max, edge_mlp.fused_edge_mlp_max, K9_KEYS,
            K9_KEYS, edge_mlp.fused_edge_mlp_max_ref, tol=K9_TOL)


if __name__ == "__main__":
    main()
