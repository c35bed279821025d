"""Sweep K2's launch shape at the flagship's group-reduce sites (GPU).

Two knobs of ``ops/group_reduce.py``: the rows a chunk (``_ROWS``, 64, 32
or 16 where the buffers fit) and ``_MAX_TQ``, the most queries a block
takes (which sets the waves of blocks).  The sites take the widths of
``configs/nuscenes.yaml`` at n_pad 36864 (KITTI's sa-geo site too) with
random inputs and masks of the site's live density (sa-geo ~3.6 live slots
of 25) and the last 4% of the queries with none, as budget padding leaves
them.  Each setting is checked against the plain version (1e-4 of the
output scale) and timed with CUDA events, median of 5.  Run::

    python -m curvecloudnet_tpu_torch.tools.k2_sweep

Prints one JSON line of milliseconds per site (keys ``rows/max_tq`` and
``plain``), then their totals.
"""

from __future__ import annotations

import itertools
import json

import torch

from ..ops import group_reduce as G

# name, K slots, M queries, message widths, attention widths (None: max),
# live fraction of the slots
SITES = [("sa-geo", 25, 23040, (64, 128, 192, 256), (256, 256, 256), 0.15),
         ("sgcnn64", 21, 23040, (64, 64, 64), None, 0.6),
         ("sa5", 32, 11520, (128, 128, 128), (128, 64, 128), 0.45),
         ("sgcnn128", 21, 11520, (128, 128), None, 0.8),
         ("sa8", 32, 5760, (256, 256, 256), (256, 128, 256), 0.55),
         ("sgcnn256", 21, 5760, (256, 256), None, 0.8),
         ("sa11", 32, 1728, (512, 512, 512), (512, 256, 512), 0.8),
         ("sgcnn512", 21, 1728, (512, 512), None, 0.8),
         ("sa14", 32, 519, (1024, 1024, 1024), None, 0.85),
         ("sgcnn1024", 21, 519, (1024, 1024), None, 0.85),
         ("kitti-sa-geo", 31, 73728, (64, 128, 192, 256), (256, 256, 256),
          0.1)]
ROWS = (64, 32, 16)
MAX_TQ = (16, 32, 64)


def cuda_ms(fn, reps: int = 5) -> float:
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


def site_inputs(k, m, widths, att, live, g, dev):
    def layers(ws):
        return tuple((w.to(dev), b.to(dev)) for w, b in (
            (torch.randn(a, c, generator=g) / a ** 0.5,
             0.1 * torch.randn(c, generator=g))
            for a, c in zip(ws[:-1], ws[1:])))
    h1 = torch.randn(1, k, m, widths[0], generator=g).to(dev)
    mask = torch.rand(1, m, k, generator=g) < live
    mask[:, int(0.96 * m):] = False         # budget padding at the end
    aff = (0.5 + torch.rand(widths[0], generator=g),
           0.1 * torch.randn(widths[0], generator=g))
    return (h1, mask.to(dev), tuple(t.to(dev) for t in aff), layers(widths),
            None if att is None else layers(att))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_sweep: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows0, tq0 = G._ROWS, G._MAX_TQ
    totals = {}
    try:
        for name, k, m, widths, att, live in SITES:
            args = site_inputs(k, m, widths, att, live, g, dev)
            kw = dict(aggr="max" if att is None else "attend", act="relu")
            dims = tuple(widths) + (tuple(att[1:]) if att else ())
            with torch.inference_mode():
                ref = G.group_reduce_ref(*args, **kw)
                row = {"plain": cuda_ms(lambda: G.group_reduce_ref(*args, **kw))}
                for rows, tq in itertools.product(ROWS, MAX_TQ):
                    G._ROWS, G._MAX_TQ = (rows,), tq
                    try:
                        G._launch_shape(dims, widths[-1], att is not None, k,
                                        m, 132)
                    except ValueError:       # this many rows do not fit
                        continue
                    out = G.group_reduce(*args, **kw)
                    err = float((out - ref).abs().max()) / max(
                        1.0, float(ref.abs().max()))
                    if err > 1e-4:
                        raise AssertionError(f"{name} {rows}/{tq}: err {err}")
                    row[f"{rows}/{tq}"] = cuda_ms(
                        lambda: G.group_reduce(*args, **kw))
            for key, v in row.items():
                totals[key] = totals.get(key, 0.0) + v
            print(name, json.dumps(row), flush=True)
    finally:
        G._ROWS, G._MAX_TQ = rows0, tq0
    print("total", json.dumps(totals))


if __name__ == "__main__":
    main()
