"""The check that no run loads JAX or the JAX package: the top-level name
of every loaded module (the part before the first dot) is compared whole,
so the port, vnl_tpu_torch, passes and vnl_tpu does not."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vnl_tpu"})


def forbidden(module_names: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    return sorted(n for n in module_names
                  if n.split(".", 1)[0] in FORBIDDEN)
