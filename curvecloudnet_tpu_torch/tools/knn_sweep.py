"""Time K3 on rows that defeat its tile boxes (GPU).

K3 (``csrc/knn.cu``) opens only the 32-point tiles whose bounding box is
not proven too far.  A row in scan order, as the model's rows are, keeps a
query's neighbours in a few tiles; a row without that order gives every
tile a box spanning the cloud, and every tile is opened: the brute-force
case.  For each K3 site of the nuScenes and KITTI forwards (Q, N, k and
radius as ``chip_smoke.py`` phases 3 and 9 print them, every point
valid), three rows: the port's synthetic sweep in scan order, the same
points shuffled, and ``randn`` points (the card tests').  Each call is
held against the plain version (distances equal, indices equal except
between equal distances) and timed with CUDA events (median of 5), beside
the share of (query, tile) pairs opened.  Run::

    python -m curvecloudnet_tpu_torch.tools.knn_sweep

Prints one JSON line per (site, row): ``{"site", "row", "q", "n", "k",
"radius", "ms", "visited"}``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..data.synthetic import lidar_sweep
from ..ops import knn

# (site, queries (None: the row's own table), points, k, radius)
SITES = [("nuScenes table 0", None, 23040, 32, 0.04),
         ("nuScenes table 1", None, 11520, 32, 0.1),
         ("nuScenes table 2", None, 5760, 32, 0.3),
         ("nuScenes table 3", None, 1728, 32, 0.5),
         ("KITTI table 0", None, 18432, 32, 0.3),
         ("nuScenes fp 8", 14977, 11520, 3, None),
         ("KITTI fp 6", 47924, 36864, 3, None)]
ROWS = ("scan", "shuffled", "randn")


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


def points(kind, n, rng):
    """(n, 3) f32 points of one row kind: a lidar-like sweep in scan order
    (32 beams, as the flagship's rows), those points shuffled, or randn."""
    if kind == "randn":
        return rng.normal(size=(n, 3)).astype(np.float32)
    pts = lidar_sweep(rng, 2 * n, 32)[0]
    pts = pts[np.sort(rng.permutation(len(pts))[:n])]
    return pts[rng.permutation(n)] if kind == "shuffled" else pts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("knn_sweep: needs a CUDA device")
    dev = torch.device("cuda")
    for site, nq, n, k, radius in SITES:
        for kind in ROWS:
            rng = np.random.default_rng(0)
            both = points(kind, n + (nq or 0), rng)
            if nq is None:
                p = q = torch.from_numpy(both)[None].to(dev)
            else:
                # the query set and the row: a split of one sweep, each in
                # the sweep's order
                pick = np.zeros(len(both), bool)
                pick[rng.permutation(len(both))[:n]] = True
                p = torch.from_numpy(both[pick])[None].to(dev)
                q = torch.from_numpy(both[~pick])[None].to(dev)
            args = (q, p, torch.ones(q.shape[:2], dtype=torch.bool,
                                     device=dev),
                    torch.ones(p.shape[:2], dtype=torch.bool, device=dev))
            i_k, d_k = knn.knn_search(*args, k, radius)
            i_r, d_r = knn.knn_search_ref(*args, k, radius)
            if not torch.equal(d_k, d_r) or \
                    bool(((i_k != i_r) & (d_k != d_r)).any()):
                raise AssertionError(f"knn {site} on {kind} rows differs "
                                     "from its plain version")
            seen, total = knn.tile_visits(*args, k, radius)
            ms = cuda_ms(lambda: knn.knn_search(*args, k, radius))
            print(json.dumps({"site": site, "row": kind, "q": q.shape[1],
                              "n": n, "k": k, "radius": radius, "ms": ms,
                              "visited": seen / max(total, 1)}), flush=True)


if __name__ == "__main__":
    main()
