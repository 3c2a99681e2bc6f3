"""Environment registry (PyTorch counterpart of vnl_tpu/envs/registry.py):
envs constructed by name, as the training command line builds them."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_environment(name: str, ctor: Callable) -> None:
    _REGISTRY[name] = ctor


def get_environment(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"unknown environment {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
