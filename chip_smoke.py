#!/usr/bin/env python3
"""Proof that the PyTorch port serves and trains on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of curvecloudnet_tpu_torch/csrc (nvcc, sm_90a);
  3. one capture eval forward of the nuScenes flagship at n_pad 36864, B=1,
     recording every eval kernel call (K1, K2, K3, K6, K4); each recorded
     call is re-run through the kernel and through its plain PyTorch
     version and the outputs compared (tolerances below), both timed with
     CUDA events;
  4. launch counters set to 0, three synthetic scans (seeds 0, 1, 2) served
     through ``predict``; each kernel's count must equal the spec-derived
     count per scan;
  5. the same first scan through the plain versions on the card: logits
     within 2e-3;
  6. one capture train step (n_pad 36864, B=1, synthetic sweep 0 and its
     labels, NLL + Lovász) recording K7's forward and backward and K4/K4b;
     each recorded call re-run through the kernel and its plain version,
     compared and timed (the backward under the call's own cotangents;
     the plain backward takes the plain forward's residuals; backward
     outputs compared in relative L2 norm against a perturbation
     yardstick, see TRAIN_KERNELS);
  7. launch counters set to 0, five train steps through ``train_step``:
     losses finite and falling, K7/K4/K4b/K3/K6 launches equal to five
     times the spec-derived counts;
  8. one train step from the same weights through the kernels and through
     the plain versions: loss within 1e-4 relative, running statistics
     within 1e-5 (relative to max(1, |stat|)), every parameter gradient
     within 2e-3 of that parameter's largest -- or, for a gradient the
     model's own conditioning cannot hold to that, within 3x the plain
     path's change under a 1e-5 relative weight perturbation plus 2e-3
     (plus 1e-5 of the largest gradient, for gradients that are zero in
     exact arithmetic; each parameter's verdict is printed).

Prints per-phase lines, then a JSON line of the kernels, the card's name
and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "nuscenes.yaml")
N_PAD = 36864
SCANS = 3
TRAIN_STEPS = 5
LR = 5e-4
LOGIT_TOL = 2e-3  # the full-model bar of the JAX package's parity tests
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# FP32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

# (name, module, wrapper, plain version, source, Pallas call it replaces,
#  tolerance: max |kernel - plain| / max(1, max |plain|) on float outputs)
EVAL_KERNELS = [
    ("conv1d_chain", "conv1d_chain", "conv1d_chain_eval",
     "conv1d_chain_eval_ref", "curvecloudnet_tpu_torch/csrc/conv1d_chain.cu",
     "curvecloudnet_tpu/ops/pallas_conv1d.py:128", 1e-4),
    ("group_reduce", "group_reduce", "group_reduce", "group_reduce_ref",
     "curvecloudnet_tpu_torch/csrc/group_reduce.cu",
     "curvecloudnet_tpu/ops/pallas_group.py:264", 1e-4),
    ("knn", "knn", "knn_search", "knn_search_ref",
     "curvecloudnet_tpu_torch/csrc/knn.cu",
     "curvecloudnet_tpu/ops/pallas_knn.py:232", 0.0),
    ("fps", "fps", "fps_picks", "fps_picks_ref",
     "curvecloudnet_tpu_torch/csrc/fps.cu",
     "curvecloudnet_tpu/ops/pallas_fps.py:78", 0.0),
    ("gather", "gather", "gather_km", "gather_km_ref",
     "curvecloudnet_tpu_torch/csrc/gather.cu",
     "curvecloudnet_tpu/ops/pallas_gather.py:213", 0.0),
]
# K7's tolerances: forward 1e-4 (max abs); backward, in relative L2 norm
# per output, 1e-3 plus 3x the plain version's own change when h1 is
# perturbed by 1e-5 relative (an accumulated rounding of a 1024-long dot
# product is ~2e-6, so the yardstick must move more): act' jumps at 0 and a max picks one of two
# near-equal slots, so rare rows within rounding of such a point take
# another branch in the kernel than in the plain version, moving single
# elements by up to their own size (measured up to 3.9e-3 in L2 at the
# flagship's 519- and 1728-query sites)
TRAIN_KERNELS = [
    ("group_train_fwd", "group_train", "group_train_fwd",
     "group_train_fwd_ref", "curvecloudnet_tpu_torch/csrc/group_train.cu",
     "curvecloudnet_tpu/ops/pallas_group_train.py:591", 1e-4),
    ("group_train_bwd", "group_train", "group_train_bwd",
     "group_train_bwd_ref", "curvecloudnet_tpu_torch/csrc/group_train.cu",
     "curvecloudnet_tpu/ops/pallas_group_train.py:591", 1e-3),
    ("gather", "gather", "gather_km", "gather_km_ref",
     "curvecloudnet_tpu_torch/csrc/gather.cu",
     "curvecloudnet_tpu/ops/pallas_gather.py:213", 0.0),
    ("scatter", "gather", "scatter_km", "scatter_km_ref",
     "curvecloudnet_tpu_torch/csrc/gather.cu",
     "curvecloudnet_tpu/ops/pallas_gather.py:237", 1e-5),
]
# the kernels of the train path counted in phase 7 (the four above, K3, K6)
TRAIN_COUNTED = [("group_train_fwd", "group_train", "group_train_fwd"),
                 ("group_train_bwd", "group_train", "group_train_bwd"),
                 ("gather", "gather", "gather_km"),
                 ("scatter", "gather", "scatter_km"),
                 ("knn", "knn", "knn_search"), ("fps", "fps", "fps_picks")]


def log(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def replaced(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def cuda_ms(fn, reps=3):
    """Median milliseconds of ``fn()`` on the current stream."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _err(name, out, ref, tol, rows=None):
    """Max abs error of a float output, raising past ``tol`` relative to
    max(1, max |ref|)."""
    import torch

    if rows is not None:
        out, ref = out[rows], ref[rows]
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    if not bool(torch.isfinite(out).all()) or err / scale > tol:
        raise AssertionError(f"{name}: max abs err {err} (scale {scale})")
    return err


def compare(name, out, ref, tol):
    """Max abs error of kernel vs plain, raising past the tolerance.
    knn: indices equal except between slots of equal distance; fps, gather:
    equal."""
    if name == "knn":
        (i_k, d_k), (i_r, d_r) = out, ref
        err = float((d_k - d_r).abs().max())
        swap = (i_k != i_r) & (d_k != d_r)
        if err > tol or bool(swap.any()):
            raise AssertionError(f"knn: dist err {err}, "
                                 f"{int(swap.sum())} index mismatches")
        return err
    if name == "fps":
        err = float((out.long() - ref.long()).abs().max())
        if err > tol:
            raise AssertionError(f"fps: picks differ (max |diff| {err})")
        return err
    return _err(name, out, ref, tol)


def _rows(mask):
    """Query rows with at least one neighbor (fully masked rows carry junk
    by contract)."""
    return mask.any(-1)


def compare_train(name, args, kern_out, ref_fn, tol):
    """Kernel outputs of a recorded train call against its plain version.
    Returns (max abs err, plain callable for timing)."""
    import torch

    from curvecloudnet_tpu_torch.ops import group_train as G

    if name == "group_train_fwd":
        h1, mask, cfg, params = args
        ref = ref_fn(*args)
        rows = _rows(mask)
        err = _err(name, kern_out[0], ref[0], tol, rows)
        for (mu, var), (r_mu, r_var) in zip(kern_out[1], ref[1]):
            err = max(err, _err(name + " mean", mu, r_mu, tol),
                      _err(name + " var", var, r_var, tol))
        return err, lambda: ref_fn(*args)
    if name == "group_train_bwd":
        h1, mask, cfg, params, stats, n, extras, dout = args
        # the plain backward with the plain forward's own residuals (a max
        # aggregation's ties are exact equalities of recomputed values)
        _, r_stats, r_n, r_extras = G.group_train_fwd_ref(h1, mask, cfg,
                                                         params)
        r_args = (h1, mask, cfg, params, r_stats, r_n, r_extras, dout)
        d_h1, grads = ref_fn(*r_args)
        g = torch.Generator(device=h1.device).manual_seed(7)
        h1_s = h1 * (1 + 1e-5 * torch.randn(h1.shape, generator=g,
                                            device=h1.device))
        _, s_stats, s_n, s_extras = G.group_train_fwd_ref(h1_s, mask, cfg,
                                                         params)
        s_h1, s_grads = ref_fn(h1_s, mask, cfg, params, s_stats, s_n,
                               s_extras, dout)
        outs = list(zip((kern_out[0],) + tuple(kern_out[1]),
                        (d_h1,) + tuple(grads), (s_h1,) + tuple(s_grads)))
        # gradients that are zero in exact arithmetic (a bias before a BN)
        # are held to 1e-3 of the call's largest output norm
        floor = 1e-3 * max(float(want.norm()) for _, want, _ in outs)
        err = worst = 0.0
        for i, (got, want, shaken) in enumerate(outs):
            scale = max(float(want.norm()), floor)
            rel = float((got - want).norm()) / scale
            bound = tol + 3 * float((shaken - want).norm()) / scale
            if not bool(torch.isfinite(got).all()) or rel > bound:
                raise AssertionError(f"{name}: output {i} (0: d_h1, then the "
                                     f"params' gradients) relative L2 err "
                                     f"{rel} > {bound}")
            err = max(err, float((got - want).abs().max()))
            worst = max(worst, rel / bound)
        log(f"  {name}: relative L2 errors within {worst:.3g} of their bounds")
        return err, lambda: ref_fn(*r_args)
    ref = ref_fn(*args)
    return _err(name, kern_out, ref, tol), lambda: ref_fn(*args)


def work(name, args, out):
    """(bytes, FP32 flops) the function must move and do on this call's
    inputs: each input read once, each output written once; data-dependent
    work (masked rows, valid points) counted for this call's data."""
    import torch

    def nbytes(*ts):
        total = 0
        for t in ts:
            if torch.is_tensor(t):
                total += t.numel() * t.element_size()
            elif isinstance(t, (tuple, list)):
                total += nbytes(*t)
        return total

    if name == "conv1d_chain":
        xe, weights, used, h = args
        rows = int(used.sum())
        flops = sum(2 * rows * w.shape[0] * w.shape[1] for w, _ in weights)
        return nbytes(xe, weights, used, out), flops
    if name == "group_reduce":
        h1, mask, aff, local, att = args[:5]
        rows = int(mask.sum())
        macs = sum(w.shape[0] * w.shape[1] for w, _ in tuple(local) +
                   tuple(att or ()))
        return nbytes(h1, mask, aff, local, att, out), 2 * rows * macs
    if name == "knn":
        q, p, qv, pv = args[:4]
        return nbytes(q, p, qv, pv, out), 8 * int(qv.sum()) * int(pv.sum())
    if name == "fps":
        pos, valid, start, budget = args
        return nbytes(pos, valid, start, out), 9 * budget * int(valid.sum())
    if name in ("gather", "scatter"):
        return nbytes(*args[:2], out), 0
    cfg = args[2]
    rows = int(args[1].sum())
    macs = sum(a * b for a, b in zip(cfg.dims[:-1], cfg.dims[1:]))
    if cfg.attend:
        macs += 2 * cfg.dims[-1] * cfg.att_dim
    # the backward recomputes the chain (no activation is an input) and
    # takes two products per dense: 3x the forward's multiply-adds
    mult = 2 if name == "group_train_fwd" else 6
    return nbytes(args[:2], args[3:], out), mult * rows * macs


def library_call(name, args):
    """One PyTorch call computing the same function, where one exists:
    K4 ``index_select`` of the clamped rows, K4b ``index_add_`` (both the
    fill=False function: a filled gather needs a second call)."""
    import torch

    if name == "gather":
        src, idx = args[:2]
        flat = idx.clamp(min=0).long().reshape(idx.shape[0], -1)
        return lambda: [torch.index_select(src[b], 0, flat[b])
                        for b in range(src.shape[0])]
    if name == "scatter":
        d, idx, n = args[:3]
        flat = idx.clamp(min=0).long().reshape(idx.shape[0], -1)
        dd = d.reshape(d.shape[0], -1, d.shape[-1])
        out = torch.zeros((d.shape[0], n, d.shape[-1]), device=d.device)
        return lambda: [out[b].index_add_(0, flat[b], dd[b])
                        for b in range(d.shape[0])]
    return None


def capture(kernels, mods, run):
    """Run ``run()`` with a recorder on every listed wrapper -> {name: [(args,
    kwargs, output)]}."""
    import torch

    calls = {name: [] for name, *_ in kernels}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name].append((args, kwargs, out))
            return out
        # the wrapper counts through its module-level name, i.e. on this
        # stand-in while it is installed; those counts are not the main path's
        wrapped.launches = 0
        return wrapped

    with contextlib.ExitStack() as stack:
        for name, mod, wrapper, *_ in kernels:
            m = mods[mod]
            stack.enter_context(replaced(
                m, wrapper, recorder(name, getattr(m, wrapper))))
        result = run()
        torch.cuda.synchronize()
    return calls, result


def measure(kernels, mods, calls, train):
    """Compare and time every recorded call -> report rows."""
    import torch

    report = {}
    for name, mod, wrapper, ref_name, source, replaces, tol in kernels:
        kern = getattr(mods[mod], wrapper)
        ref = getattr(mods[mod], ref_name)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_by": "bytes", "library_ms": None}
        flops_total = bytes_total = 0
        for args, kwargs, out in calls[name]:
            with torch.no_grad():
                if train:
                    e, plain = compare_train(name, args, out, ref, tol)
                else:
                    e = compare(name, kern(*args, **kwargs),
                                ref(*args, **kwargs), tol)
                    plain = lambda: ref(*args, **kwargs)  # noqa: E731
                reps = 1 if train else 3
                k_ms = cuda_ms(lambda: kern(*args, **kwargs), reps)
                r_ms = cuda_ms(plain, reps)
                lib = library_call(name, args)
                if lib is not None:
                    row["library_ms"] = (row["library_ms"] or 0.0) + cuda_ms(
                        lib, reps)
            nb, fl = work(name, args, out)
            bytes_total, flops_total = bytes_total + nb, flops_total + fl
            row["bound_ms"] += max(nb / PEAK_BYTES, fl / PEAK_FP32) * 1e3
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            log(f"  {name} {shapes}: err {e:.3g}, kernel {k_ms:.3f} ms, "
                f"plain {r_ms:.3f} ms")
            row["max_abs_err"] = max(row["max_abs_err"], e)
            row["ms"] += k_ms
            row["plain_ms"] += r_ms
        row["bound_by"] = ("operations" if flops_total / PEAK_FP32
                           > bytes_total / PEAK_BYTES else "bytes")
        log(f"compare {name}: {len(calls[name])} calls, max abs err "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}), library {row['library_ms']}")
        report[name] = row
    return report


def grads_and_stats(model):
    return ({k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None},
            {k: b.detach().clone() for k, b in model.named_buffers()})


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, REPO)
    from curvecloudnet_tpu_torch import predict as P
    from curvecloudnet_tpu_torch.models import kernel_launches
    from curvecloudnet_tpu_torch.ops import _build
    from curvecloudnet_tpu_torch.ops import (conv1d_chain, fps, gather,
                                             group_reduce, group_train, knn)
    from curvecloudnet_tpu_torch.train import LossConfig, train_step
    from curvecloudnet_tpu_torch.train.__main__ import synthetic_batch
    from curvecloudnet_tpu_torch.train.trainer import create_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"conv1d_chain": conv1d_chain, "group_reduce": group_reduce,
            "knn": knn, "fps": fps, "gather": gather,
            "group_train": group_train}
    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log("card:", smi)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR / _build.LIB_NAME})")

    # 3. capture one eval forward, compare and time every recorded call
    model = P.build_model(CONFIG, N_PAD, dev)
    scan0 = P.synthetic_scan(0, N_PAD, dev)
    calls, (logits0, valid0, _) = capture(
        EVAL_KERNELS, mods, lambda: P.predict(model, *scan0))
    eval_report = measure(EVAL_KERNELS, mods, calls, train=False)
    del calls

    # 4. the eval path: three scans through predict, launches counted
    want = kernel_launches(model.spec, N_PAD)
    for name, mod, wrapper, *_ in EVAL_KERNELS:
        getattr(mods[mod], wrapper).launches = 0
    scan_ms = []
    for seed in range(SCANS):
        inputs = scan0 if seed == 0 else P.synthetic_scan(seed, N_PAD, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, valid, pred = P.predict(model, *inputs)
        torch.cuda.synchronize()
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        live = logits[valid]
        if logits.shape != (1, N_PAD, model.spec.n_out) or not bool(
                torch.isfinite(live).all()):
            raise AssertionError(f"scan {seed}: bad logits {tuple(logits.shape)}")
        log(f"scan {seed}: {scan_ms[-1]:.1f} ms, {int(valid.sum())} valid points")
    eval_launched = {name: getattr(mods[mod], w).launches
                     for name, mod, w, *_ in EVAL_KERNELS}
    log("eval launches:", eval_launched, "spec per scan:", want)
    for name, got in eval_launched.items():
        if got != SCANS * want[name] or not got:
            raise AssertionError(f"{name}: {got} launches, "
                                 f"want {SCANS} x {want[name]}")

    # 5. the plain eval path on the card
    with contextlib.ExitStack() as stack:
        for name, mod, wrapper, ref_name, *_ in EVAL_KERNELS:
            m = mods[mod]
            stack.enter_context(replaced(m, wrapper, getattr(m, ref_name)))
        plain, _, _ = P.predict(model, *scan0)
        plain_ms = cuda_ms(lambda: P.predict(model, *scan0), reps=1)
    err = float((logits0 - plain)[valid0].abs().max())
    log(f"logits kernel path vs plain path on the card: max abs err {err:.3g}; "
        f"plain forward {plain_ms:.1f} ms")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"logits differ from the plain path by {err}")
    log(f"per-scan latency ms: {scan_ms}")
    del model, plain, logits0

    # 6. capture one train step, compare and time every recorded call
    loss_cfg = LossConfig(ignore_index=0, use_lovasz=True)
    batch = synthetic_batch(0, N_PAD, dev)
    init = P.build_model(CONFIG, N_PAD, dev).train()
    state0 = copy.deepcopy(init.state_dict())

    def one_step(model, plain_path=False, shaken=False, lr=LR):
        """One train step of a fresh copy of the initial weights."""
        model.load_state_dict(state0)
        if shaken:
            g = torch.Generator(device=dev).manual_seed(5)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 1e-5 * torch.randn(p.shape, generator=g,
                                                  device=dev))
        opt = create_optimizer(model)
        gen = torch.Generator(device=dev).manual_seed(0)
        with contextlib.ExitStack() as stack:
            if plain_path:
                for name, mod, wrapper, ref_name, *_ in (EVAL_KERNELS
                                                         + TRAIN_KERNELS):
                    m = mods[mod]
                    stack.enter_context(replaced(m, wrapper,
                                                 getattr(m, ref_name)))
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(model, opt, lr, batch, gen, 0.1, loss_cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return float(out["loss"]), ms, torch.cuda.max_memory_allocated()

    # learning rate 0: the recorded calls hold views of the weights
    calls, (cap_loss, cap_ms, _) = capture(
        TRAIN_KERNELS, mods, lambda: one_step(init, lr=0.0))
    log(f"train capture step: loss {cap_loss:.6g}, {cap_ms:.1f} ms")
    train_report = measure(TRAIN_KERNELS, mods, calls, train=True)
    del calls

    # 7. the train path: five steps through train_step, launches counted
    want_t = kernel_launches(init.spec, N_PAD, train=True)
    for name, mod, wrapper in TRAIN_COUNTED:
        getattr(mods[mod], wrapper).launches = 0
    init.load_state_dict(state0)
    opt = create_optimizer(init)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(train_step(init, opt, LR, batch, gen, 0.1,
                                loss_cfg)["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        log(f"train step {step}: loss {loss:.6g}, {step_ms[-1]:.1f} ms")
    kernel_peak = torch.cuda.max_memory_allocated()
    train_launched = {name: getattr(mods[mod], w).launches
                      for name, mod, w in TRAIN_COUNTED}
    log("train launches:", train_launched, "spec per step:", want_t)
    for name, got in train_launched.items():
        if got != TRAIN_STEPS * want_t[name] or not got:
            raise AssertionError(f"{name}: {got} launches in train, "
                                 f"want {TRAIN_STEPS} x {want_t[name]}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")

    # 8. one step from the same weights: kernel path against plain path
    results = {}
    for label, plain_path, shaken in [("kernel", False, False),
                                      ("plain", True, False),
                                      ("plain, weights x (1 + 1e-5 noise)",
                                       True, True)]:
        loss, ms, peak = one_step(init, plain_path, shaken)
        results[label] = (loss, ms, peak, *grads_and_stats(init))
        log(f"one step, {label} path: loss {loss:.8g}, {ms:.1f} ms, peak "
            f"memory {peak / 2**30:.2f} GiB")
    k_loss, _, _, k_grads, k_bufs = results["kernel"]
    p_loss, _, _, p_grads, p_bufs = results["plain"]
    _, _, _, s_grads, s_bufs = results["plain, weights x (1 + 1e-5 noise)"]
    if abs(k_loss - p_loss) > 1e-4 * abs(p_loss):
        raise AssertionError(f"loss: kernel {k_loss} vs plain {p_loss}")
    stat_bar = stat_yard = 0
    for name, v in p_bufs.items():
        scale = max(1.0, float(v.abs().max()))
        err = float((k_bufs[name] - v).abs().max())
        if err <= 1e-5 * scale:
            stat_bar += 1
            continue
        noise = float((s_bufs[name] - v).abs().max())
        log(f"  running statistic {name}: err {err:.3g} > 1e-5 x {scale:.3g};"
            f" plain path's 1e-5-perturbation change {noise:.3g}")
        if err > 3 * noise + 1e-5 * scale:
            raise AssertionError(f"running statistic {name} differs by {err}")
        stat_yard += 1
    log(f"running statistics: {stat_bar} within 1e-5, {stat_yard} within the "
        f"perturbation yardstick")
    if k_grads.keys() != p_grads.keys():
        raise AssertionError("gradients: different parameter sets")
    bar = yardstick = 0
    worst = (0.0, "")
    # gradients that are zero in exact arithmetic (a bias before a BN) are
    # rounding noise on both paths: floored at 1e-5 of the largest gradient
    floor = 1e-5 * max(float(g.abs().max()) for g in p_grads.values())
    for name, g in p_grads.items():
        scale = float(g.abs().max())
        err = float((k_grads[name] - g).abs().max())
        if err <= 2e-3 * scale:
            bar += 1
            continue
        noise = float((s_grads[name] - g).abs().max())
        ratio = err / (3 * noise + 2e-3 * scale + floor)
        worst = max(worst, (ratio, name))
        log(f"  gradient {name}: err {err:.3g} of max {scale:.3g} > 2e-3; "
            f"plain path's 1e-5-perturbation change {noise:.3g}")
        if ratio > 1:
            raise AssertionError(f"gradient {name}: err {err} beyond "
                                 f"3 x {noise} + 2e-3 x {scale} + {floor}")
        yardstick += 1
    log(f"gradients: {bar} within 2e-3 of their max, {yardstick} within the "
        f"perturbation yardstick (worst {worst[0]:.3g} of its bound, "
        f"{worst[1]})")
    log(f"train: capture step {cap_ms:.1f} ms; steps {step_ms} ms; kernel "
        f"path peak memory {kernel_peak / 2**30:.2f} GiB; plain step "
        f"{results['plain'][1]:.1f} ms, peak "
        f"{results['plain'][2] / 2**30:.2f} GiB; losses {losses}")

    reference = [m for m in sys.modules
                 if m.split(".")[0] in ("jax", "flax", "curvecloudnet_tpu")]
    if reference:
        raise AssertionError(f"the port loaded the JAX package: {reference}")

    report = dict(eval_report)
    for name, row in train_report.items():
        if name in report:   # gather: both paths; the train capture's times
            row["max_abs_err"] = max(row["max_abs_err"],
                                     report[name]["max_abs_err"])
        report[name] = row
    for name, row in report.items():
        by_path = {"eval": eval_launched.get(name, 0),
                   "train": train_launched.get(name, 0)}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    log(json.dumps({"kernels": list(report.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
