"""The weight bridge from the JAX package's flax trees to the port.

The port's parameters carry the reference torch ``state_dict`` names that
``curvecloudnet_tpu/checkpoint.py`` ``load_torch_checkpoint`` reads, so
:func:`from_jax_variables` is that function's inverse, and a released
reference ``.pth`` loads into the port as it is.  Every map below is
linear, so ``from_jax_variables(grads, {}, spec)`` also carries a flax
gradient tree (the params' structure) to the port's parameter names:

  step_{i}_{name}/nn, attend_nn   -> steps.{i}.conv.local_nn / conv.attend_nn
                                     (sa, sa-geo)
  step_{i}_{name}/nn, attend_nn   -> steps.{i}.nn / steps.{i}.attend_nn
  step_{i}_{name}/mlp             -> steps.{i}.mlp                (mlp step)
  step_{i}_{name}/conv_j/kernel ((h+1)*I, O) -> steps.{i}.conv_modules.j.weight
                                                (O, I, h+1)
  step_{i}_{name}/norm_j          -> steps.{i}.norm_modules.j
  mlp                             -> mlp                          (head)
  MLP lin_N/kernel (I, O)  -> lins.N.weight (O, I);  lin_N/bias -> lins.N.bias
  norm_N scale, bias       -> norms.N.weight, norms.N.bias
  batch_stats norm_N mean, var -> norms.N.running_mean, norms.N.running_var
"""

from __future__ import annotations

from typing import Dict

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
    if "mlp" in params:
        _mlp(out, "mlp", params["mlp"], batch_stats.get("mlp", {}))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
