"""K1 and K8 at the flagship's conv shapes, each kernel's device time (GPU).

The nuScenes sweep's rows (n_exp 49164; KITTI's 143372 for K1) with random
inputs: K1 on the step_0 (C0 8) and step_31 (C0 262) chains of three
32-wide layers, h 2; K8's forward and t pass on the 8-, 32- (with the
previous layer's BN) and 262-wide layers, the 32-wide layer's t pass also
with the previous layer's reduce sums (``prev_sums``), and the standalone
reduce pass on a 32-wide layer.  Each call is timed with CUDA
events (median of 21, host enqueue included) beside its plain version,
then profiled over 10 calls (``torch.profiler``): device microseconds a
call of each CUDA kernel it launches.  Run::

    python -m curvecloudnet_tpu_torch.tools.conv_sweep

Prints the card's name, then one JSON line per call.
"""

from __future__ import annotations

import json

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import conv1d_chain as C
from ..ops import conv1d_train as T

H = 2
REPS = 21


def cuda_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
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


def device_us(fn, calls: int = 10) -> dict:
    """Device microseconds a call of each CUDA kernel ``fn`` launches, and
    under ``"launches"`` the launches the profiler recorded of each (a
    count short of the calls' marks an incomplete trace)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    out = {e.key.split("(")[0][:48]: round(e.device_time_total / calls, 2)
           for e in events}
    out["launches"] = {e.key.split("(")[0][:48]: e.count for e in events}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("conv_sweep: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    def line(name, kern, plain, **shape):
        print(json.dumps({"call": name, **shape, "ms": cuda_ms(kern),
                          "plain_ms": cuda_ms(plain),
                          "device_us": device_us(kern)}), flush=True)

    for n_exp in (49164, 143372):
        used = torch.tensor([n_exp - 300], device=dev, dtype=torch.int32)
        for c0 in (8, 262):
            xe = rn(1, n_exp, c0)
            weights, cin = [], c0
            for cout in (32, 32, 32):
                weights.append((rn((H + 1) * cin, cout,
                                   scale=((H + 1) * cin) ** -0.5),
                                rn(cout, scale=0.1)))
                cin = cout
            args = (xe, tuple(weights), used, H)
            line("K1", lambda: C.conv1d_chain_eval(*args),
                 lambda: C.conv1d_chain_eval_ref(*args), n_exp=n_exp, c_in=c0)
    n_exp = 49164
    used = torch.tensor([n_exp - 300], device=dev, dtype=torch.int32)
    for cin, with_bn in ((8, False), (32, True), (262, False)):
        z_prev = rn(1, n_exp, cin)
        w = rn((H + 1) * cin, 32, scale=((H + 1) * cin) ** -0.5)
        bn_prev = ((rn(cin, scale=0.1), 1 + 0.1 * torch.rand(
            cin, device=dev), 1 + rn(cin, scale=0.1), rn(cin, scale=0.1))
                   if with_bn else None)
        fwd = (z_prev, bn_prev, w, rn(32, scale=0.1), used, H)
        line("K8 fwd", lambda: T.conv1d_train_fwd_layer(*fwd),
             lambda: T.conv1d_train_fwd_layer_ref(*fwd), n_exp=n_exp,
             c_in=cin)
        z, mean, var = T.conv1d_train_fwd_layer_ref(*fwd)
        bn = (mean, torch.rsqrt(var + T.EPS), 1 + rn(32, scale=0.1),
              rn(32, scale=0.1))
        t = (rn(1, n_exp, 32), z, z_prev, bn, bn_prev, w,
             rn(32, scale=0.01), rn(32, scale=0.01), used, H)
        line("K8 t", lambda: T.conv1d_train_bwd_t(*t),
             lambda: T.conv1d_train_bwd_t_ref(*t), n_exp=n_exp, c_in=cin)
        if with_bn:
            line("K8 t + reduce sums",
                 lambda: T.conv1d_train_bwd_t(*t, prev_sums=True),
                 lambda: T.conv1d_train_bwd_t_ref(*t, prev_sums=True),
                 n_exp=n_exp, c_in=cin)
            red = (t[0], z, bn, used)
            line("K8 reduce", lambda: T.conv1d_train_bwd_reduce(*red),
                 lambda: T.conv1d_train_bwd_reduce_ref(*red), n_exp=n_exp,
                 c=32)


if __name__ == "__main__":
    main()
