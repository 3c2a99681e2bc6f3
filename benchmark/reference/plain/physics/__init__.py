"""Batched rigid-body physics in PyTorch (counterpart of vnl_tpu.physics).

The submodules keep the JAX package's names; ``forward`` here is the
module (import the function from ``benchmark.reference.plain.physics.forward``)."""

from benchmark.reference.plain.physics.model import Data, Model, Option
