"""The weight bridge from the JAX package's flax trees to the port, and
the port's native checkpoints (``save_checkpoint`` / ``restore_checkpoint``
with the JAX package's ``latest_state.json`` resume contract).

The port's parameters carry the reference torch ``state_dict`` names that
``curvecloudnet_tpu/checkpoint.py`` ``load_torch_checkpoint`` reads, so
:func:`from_jax_variables` is that function's inverse, and a released
reference ``.pth`` loads into the port through
:func:`load_reference_state_dict` (which renames torch_geometric's
``norms.N.module.*`` and drops BatchNorm's ``num_batches_tracked``).  Every
map below is
linear, so ``from_jax_variables(grads, {}, spec)`` also carries a flax
gradient tree (the params' structure) to the port's parameter names:

  step_{i}_{name}/nn, attend_nn   -> steps.{i}.conv.local_nn / conv.attend_nn
                                     (sa, sa-geo)
  step_{i}_{name}/nn, attend_nn   -> steps.{i}.nn / steps.{i}.attend_nn
                                     (sgcnn, fp, fp-geo, skip-connect,
                                     sa-global)
  step_{i}_{name}/mlp             -> steps.{i}.mlp                (mlp step)
  step_{i}_{name}/conv_j/kernel ((h+1)*I, O) -> steps.{i}.conv_modules.j.weight
                                                (O, I, h+1)
  step_{i}_{name}/norm_j          -> steps.{i}.norm_modules.j
  mlp                             -> mlp                          (head)
  lin_categorical                 -> lin_categorical   (category embedding)
  MLP lin_N/kernel (I, O)  -> lins.N.weight (O, I);  lin_N/bias -> lins.N.bias
  norm_N scale, bias       -> norms.N.weight, norms.N.bias
  batch_stats norm_N mean, var -> norms.N.running_mean, norms.N.running_var
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _norm(out, prefix, params, stats):
    for k, v in params.items():
        out[f"{prefix}.{_BN[k]}"] = np.asarray(v)
    for k, v in stats.items():
        out[f"{prefix}.{_STATS[k]}"] = np.asarray(v)


def _mlp(out, prefix, params, stats):
    for name, sub in params.items():
        kind, j = name.split("_")
        if kind == "lin":
            out[f"{prefix}.lins.{j}.weight"] = np.asarray(sub["kernel"]).T
            if "bias" in sub:
                out[f"{prefix}.lins.{j}.bias"] = np.asarray(sub["bias"])
        else:
            _norm(out, f"{prefix}.norms.{j}", sub, stats.get(name, {}))


def _step_prefixes(i: int, step_name: str):
    if step_name in ("sa", "sa-geo"):
        return {"nn": f"steps.{i}.conv.local_nn",
                "attend_nn": f"steps.{i}.conv.attend_nn"}
    return {"nn": f"steps.{i}.nn", "attend_nn": f"steps.{i}.attend_nn",
            "mlp": f"steps.{i}.mlp"}


def from_jax_variables(params, batch_stats, spec) -> Dict[str, torch.Tensor]:
    """flax (params, batch_stats) trees (arrays or numpy) -> the port's
    ``state_dict`` (float32 CPU tensors)."""
    out: Dict[str, np.ndarray] = {}
    for i, step in enumerate(spec.steps):
        sname = f"step_{i}_{step.name}"
        p, s = params.get(sname, {}), batch_stats.get(sname, {})
        if step.name.startswith("conv1d"):
            for name, sub in p.items():
                kind, j = name.split("_")
                if kind == "conv":
                    k = np.asarray(sub["kernel"])
                    taps = (step.kernel_size or 5) // 2 + 1
                    w = k.reshape(taps, k.shape[0] // taps, k.shape[1])
                    out[f"steps.{i}.conv_modules.{j}.weight"] = w.transpose(2, 1, 0)
                    out[f"steps.{i}.conv_modules.{j}.bias"] = np.asarray(sub["bias"])
                else:
                    _norm(out, f"steps.{i}.norm_modules.{j}", sub, s.get(name, {}))
            continue
        prefixes = _step_prefixes(i, step.name)
        for mlp_name, sub in p.items():
            _mlp(out, prefixes[mlp_name], sub, s.get(mlp_name, {}))
    for head in ("mlp", "lin_categorical"):
        if head in params:
            _mlp(out, head, params[head], batch_stats.get(head, {}))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def load_reference_state_dict(model: torch.nn.Module,
                              state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a reference torch ``state_dict`` (a released ``.pth``, after
    ``torch.load``) into a port model, strictly: torch_geometric's
    ``norms.N.module.X`` names become ``norms.N.X`` and every
    ``num_batches_tracked`` counter is dropped (the port's BatchNorm keeps
    none; the JAX loader ignores it too)."""
    sd = {re.sub(r"(^|\.)norms\.(\d+)\.module\.", r"\1norms.\2.", k): v
          for k, v in state_dict.items()
          if not k.endswith(".num_batches_tracked")}
    model.load_state_dict(sd, strict=True)


# ---------------------------------------------------------------------------
# Native checkpoints and the resume contract
# ---------------------------------------------------------------------------
#
# The JAX package saves orbax directories; the port saves torch state dicts.
# The formats differ; the contract is shared: a checkpoint is the directory
# ``outdir/name`` (``latest`` rolling, ``epoch{E}`` periodic,
# ``best_epoch{E}`` best), and ``outdir/latest_state.json`` holds
# ``{epoch, max_score}`` of the rolling one.

CHECKPOINT_FILE = "checkpoint.pt"


def save_checkpoint(outdir: str, name: str, model: torch.nn.Module,
                    optimizer=None, step: int = 0) -> str:
    """Save the model's state dict (and the optimizer's, when given) and
    the step under ``outdir/name``."""
    path = os.path.abspath(os.path.join(outdir, name))
    os.makedirs(path, exist_ok=True)
    blob = {"model": model.state_dict(), "step": int(step),
            "optimizer": None if optimizer is None else optimizer.state_dict()}
    torch.save(blob, os.path.join(path, CHECKPOINT_FILE))
    return path


def restore_checkpoint(outdir: str, name: str, model: torch.nn.Module,
                       optimizer=None) -> int:
    """Load ``outdir/name`` into ``model`` (strictly) and ``optimizer``
    (when given; the checkpoint must hold its state) -> the saved step."""
    path = os.path.join(os.path.abspath(os.path.join(outdir, name)),
                        CHECKPOINT_FILE)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(blob["model"], strict=True)
    if optimizer is not None:
        if blob["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(blob["optimizer"])
    return int(blob["step"])


def dump_latest_state(outdir: str, epoch: int, max_score: float) -> None:
    """``latest_state.json`` (reference main.py:139-141)."""
    with open(os.path.join(outdir, "latest_state.json"), "w") as f:
        json.dump({"epoch": epoch, "max_score": max_score}, f)


def read_latest_state(outdir: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(outdir, "latest_state.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def has_latest(outdir: str) -> bool:
    return os.path.isdir(os.path.join(outdir, "latest"))
