"""The JAX package's examples (examples/) on the port, on the committed
rodent twin and its clip: ``python -m vnl_tpu_torch.examples.<name>``."""
