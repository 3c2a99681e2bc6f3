"""YAML configs with dotted-path CLI overrides (a copy of
vnl_tpu/utils/config.py): plain YAML files, shallow-merged, plus
``key.subkey=value`` overrides, no global framework state."""

from __future__ import annotations

import ast
from typing import Any, Dict, List

import yaml


def load_config(*paths: str) -> Dict[str, Any]:
    """Loads and shallow-merges YAML files (later wins)."""
    cfg: Dict[str, Any] = {}
    for p in paths:
        with open(p) as f:
            loaded = yaml.safe_load(f) or {}
        for k, v in loaded.items():
            if isinstance(v, dict) and isinstance(cfg.get(k), dict):
                cfg[k].update(v)
            else:
                cfg[k] = v
    return cfg


def _parse_value(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def apply_overrides(cfg: Dict[str, Any],
                    overrides: List[str]) -> Dict[str, Any]:
    """Applies 'a.b.c=value' style overrides in place.  A value is a
    Python literal (``True``, ``None``, ``3e-4``, ``[1, 2]``) or else a
    string, as in the JAX package."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return cfg
