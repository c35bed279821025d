"""K9, K5 and K10 at the main path's shapes, each kernel's device time
(GPU).

K9: the five calls of one nuScenes forward on the ``fused`` edge route
(``configs/nuscenes.yaml``, n_pad 36864, synthetic sweep 0, random
weights from seed 0), recorded and re-run with their own inputs.  K5: the
two KITTI grid tables' shapes (a 64-beam sweep of 73728 and of 36864
points, every point a query, k 32, radii 0.04 / 0.1, caps 192 / 64, two
overflow rows), as ``tests/test_torch_port_cuda.py`` builds them; K10 on
the same tables' candidate planes (the grid's ``planes`` tail, W = S x
cap columns a query).  Each call is timed with CUDA events (median of 11,
host enqueue included)
beside its plain version, then profiled over 10 calls
(``torch.profiler``): device microseconds a call of each CUDA kernel it
launches.  Run::

    python -m curvecloudnet_tpu_torch.tools.edge_grid_sweep

Prints the card's name, then one JSON line per call.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import predict as P
from ..ops import edge_mlp, grid_knn, grid_topk
from .conv_sweep import cuda_ms, device_us

REPS = 11
# (rows, radius, cap, hash bits): the KITTI forward's two grid tables
KITTI_TABLES = ((73728, 0.04, 192, 14), (36864, 0.1, 64, 15))


def edge_calls(dev) -> list:
    """(args) of every K9 call of one fused-route nuScenes forward."""
    model = P.build_model("configs/nuscenes.yaml", 36864, dev,
                          edge_kernel="fused")
    scan = P.synthetic_scan(0, 36864, dev)
    calls, real = [], edge_mlp.fused_edge_mlp_max

    def record(*args):
        calls.append(args)
        return real(*args)

    # the wrapper counts through its module-level name: this stand-in
    record.launches = 0
    edge_mlp.fused_edge_mlp_max = record
    try:
        P.predict(model, *scan)
    finally:
        edge_mlp.fused_edge_mlp_max = real
    return calls


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("edge_grid_sweep: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)

    def line(name, kern, plain, **shape):
        print(json.dumps({"call": name, **shape, "ms": cuda_ms(kern, REPS),
                          "plain_ms": cuda_ms(plain, REPS),
                          "device_us": device_us(kern)}), flush=True)

    with torch.no_grad():
        for args in edge_calls(dev):
            x, nbr = args[:2]
            line("K9", lambda: edge_mlp.fused_edge_mlp_max(*args),
                 lambda: edge_mlp.fused_edge_mlp_max_ref(*args),
                 n=x.shape[1], c=x.shape[2], k=nbr.shape[2],
                 widths=[w.shape[1] for w in args[2]],
                 live=int((nbr >= 0).sum()))
    for n, radius, cap, bits in KITTI_TABLES:
        pos, _, _, valid = P.synthetic_scan(0, n, dev, n_beams=64)
        table, counts, _, _, _ = grid_knn.build_table(pos, valid, radius, cap,
                                                      bits, 2)
        nbr = grid_knn.stencil_rows(pos, radius, radius, 27, bits, 2)[0]
        args = (table, counts, nbr.int().contiguous(), pos[0].contiguous(),
                valid[0].contiguous(), 32, float(np.float32(radius * radius)))
        line("K5", lambda: grid_topk.grid_topk_records(*args),
             lambda: grid_topk.grid_topk_records_ref(*args), q=n, cap=cap,
             s=nbr.shape[1], live=int(counts[nbr.long()].sum()))
        planes = grid_topk.planes(table, *args[2:5], args[6])
        line("K10", lambda: grid_topk.topk_smallest(*planes, 32),
             lambda: grid_topk.topk_smallest_ref(*planes, 32), q=n,
             w=planes[0].shape[1],
             candidates=int((planes[0] < grid_topk.INF * 0.98).sum()))
        del planes


if __name__ == "__main__":
    main()
