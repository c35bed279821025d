"""Simulated-scan dataset generation CLI (counterpart of the root
``tools/generate_shapenet.py``; the reference's
``scanning_simulator/shapenet_seg/generate_shapenet.py`` entry point).

The rasterizer (kernel K11) and the anti-aliasing filter run on
``--device`` (default ``cuda``; ``--device cpu`` runs their plain
versions).  Examples::

  # a real ShapeNetCore v1 tree with official splits + part-label transfer
  python -m curvecloudnet_tpu_torch.tools.generate_shapenet --out ./data/sim \\
      --shapenet-dir /data/ShapeNetCore.v1 --split train \\
      --split-csv /data/all.csv --labels-dir /data/shapenet_part \\
      --n-samples 512 --n-points 2048

  # no data: procedural primitives with height-quantile labels
  python -m curvecloudnet_tpu_torch.tools.generate_shapenet --out ./data/sim \\
      --n-samples 64 [--device cpu]
"""

from __future__ import annotations

import argparse

from ..config import DEFAULT_DEVICE


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-samples", type=int, default=64)
    ap.add_argument("--n-points", type=int, default=2048)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--pattern", default="random",
                    choices=["random", "parallel", "grid"])
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obj-dir", default=None)
    ap.add_argument("--shapenet-dir", default=None)
    ap.add_argument("--shapenet-version", type=int, default=1)
    ap.add_argument("--split", default="train")
    ap.add_argument("--split-csv", default="")
    ap.add_argument("--labels-dir", default="")
    ap.add_argument("--synsets", nargs="*", default=None)
    ap.add_argument("--viz", type=int, default=0, metavar="EVERY",
                    help="write QA renders (curve colors + label panel) for "
                         "every EVERY-th sample under OUT/qa")
    ap.add_argument("--viz-dir", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    from ..simulator.generate import generate_dataset

    path = generate_dataset(
        args.out, n_samples=args.n_samples, n_points=args.n_points,
        resolution=args.resolution, pattern=args.pattern,
        density=args.density, seed=args.seed, obj_dir=args.obj_dir,
        shapenet_dir=args.shapenet_dir,
        shapenet_version=args.shapenet_version, split=args.split,
        split_csv=args.split_csv, labels_dir=args.labels_dir,
        synsets=args.synsets, viz_every=args.viz, viz_dir=args.viz_dir,
        device=args.device)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
