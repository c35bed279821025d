"""Convert a reference PyTorch checkpoint (``.pth`` state dict) into a
native checkpoint of the port (counterpart of
``tools/convert_torch_checkpoint.py``)::

    python -m curvecloudnet_tpu_torch.tools.convert_checkpoint \\
        --config configs/nuscenes.yaml --weights latest_model.pth \\
        --in-dim 4 --n-out 17 --out ./out/converted

The state dict is loaded strictly into the config's model
(``checkpoint.load_reference_state_dict``: torch_geometric's
``norms.N.module.*`` renamed, ``num_batches_tracked`` dropped) and saved
with ``checkpoint.save_checkpoint`` as ``<out>/torch_import``, which
``main`` reads with ``--weights <out>/torch_import``.  On the CPU; no card
is needed.
"""

from __future__ import annotations

import argparse
import os


def convert(config: str, weights: str, in_dim: int, n_out: int,
            out: str, n_points: int = 2048) -> str:
    """-> the path of the native checkpoint."""
    import torch

    from ..checkpoint import load_reference_state_dict, save_checkpoint
    from ..config import load_config
    from ..models import CurveCloudNet, parse_model_config

    cfg = load_config(config)
    spec = parse_model_config(cfg["model"], in_dim=in_dim, n_out=n_out)
    model = CurveCloudNet(spec, n_points=n_points,
                          feat_channels=(in_dim - 3) or None)
    load_reference_state_dict(model, torch.load(
        weights, map_location="cpu", weights_only=True))
    path = save_checkpoint(out, "torch_import", model)
    n = sum(p.numel() for p in model.parameters())
    print(f"wrote {path} ({n:,} parameters)")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--in-dim", type=int, required=True)
    ap.add_argument("--n-out", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    convert(args.config, args.weights, args.in_dim, args.n_out,
            os.path.abspath(args.out))


if __name__ == "__main__":
    main()
