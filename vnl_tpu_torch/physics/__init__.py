"""Batched rigid-body physics in PyTorch (counterpart of vnl_tpu.physics).

The submodules keep the JAX package's names; ``forward`` here is the
module (import the function from ``vnl_tpu_torch.physics.forward``)."""

from vnl_tpu_torch.physics.model import Data, Model, Option
