"""Config system: YAML file + dotted-path CLI overrides (counterpart of
``curvecloudnet_tpu/config.py``).

A required ``--config`` YAML, with optional single-level ``base:
other.yaml`` inheritance resolved relative to the file, takes free-form
``--a.b.c=value`` (or ``--a.b.c value``) overrides whose values are
coerced to the type already present in the YAML (unknown keys warn and
are added).  The port adds one key, ``device`` (default ``cuda``), and
a ``--distributed.*`` override creates the ``distributed`` block (the
JAX entry's multi-process block, which no shipped config holds).
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import warnings
from typing import Any, Dict, List, Optional

import yaml

DEFAULT_DEVICE = "cuda"


def _coerce(new: str, old: Any) -> Any:
    """Coerce a CLI string to the type of the existing config value."""
    if isinstance(old, bool):
        if new.lower() in ("true", "1", "yes"):
            return True
        if new.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse bool from {new!r}")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(new)
    if isinstance(old, float):
        return float(new)
    if isinstance(old, (list, dict)) or old is None:
        try:
            return ast.literal_eval(new)
        except (ValueError, SyntaxError):
            return new
    return new


def set_dotted(cfg: Dict[str, Any], path: str, value: str,
               warn_unknown: bool = True) -> None:
    """Set ``a.b.c`` in a nested dict, coercing to the existing value type."""
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        if not isinstance(node, dict) or k not in node:
            if warn_unknown:
                warnings.warn(f"config override path {path!r} not in config")
            return
        node = node[k]
    leaf = keys[-1]
    if isinstance(node, dict) and leaf in node:
        node[leaf] = _coerce(value, node[leaf])
    else:
        if warn_unknown:
            warnings.warn(f"config override key {path!r} not in config; "
                          "adding as string")
        node[leaf] = _coerce(value, None)


def recursive_update(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``new`` into ``base`` (new wins; dicts merge recursively)."""
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            recursive_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"config {path} did not parse to a mapping")
    base = cfg.pop("base", None)
    if base:
        base_cfg = load_config(os.path.join(os.path.dirname(path), base))
        cfg = recursive_update(base_cfg, cfg)
    return cfg


def parse_args(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """The final config dict from ``--config file.yaml`` + overrides, with
    ``device`` set to ``cuda`` where neither the file nor a flag sets it."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description="curvecloudnet-tpu entry "
                                     "point (PyTorch)")
    parser.add_argument("--config", required=True, help="YAML config path")
    args, unknown = parser.parse_known_args(argv)

    cfg = load_config(args.config)
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--"):
            warnings.warn(f"ignoring stray CLI token {tok!r}")
            i += 1
            continue
        tok = tok[2:]
        if "=" in tok:
            path, value = tok.split("=", 1)
            i += 1
        else:
            path = tok
            if i + 1 >= len(unknown):
                raise ValueError(f"flag --{path} missing a value")
            value = unknown[i + 1]
            i += 2
        if path.startswith("distributed."):
            cfg.setdefault("distributed", {})
        set_dotted(cfg, path, value)
    cfg.setdefault("device", DEFAULT_DEVICE)
    return cfg


def config_summary(cfg: Dict[str, Any]) -> str:
    return yaml.safe_dump(cfg, sort_keys=False, default_flow_style=None)
