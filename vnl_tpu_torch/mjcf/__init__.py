"""MJCF compiler of the port (PyTorch counterpart of vnl_tpu/mjcf): XML ->
numpy fields -> a torch Model on a device.  The parser, the spec transforms
and the qpos0 constants are NumPy copies of the JAX package's; the compiler
ends in the numpy field dict of ``compat.model_from_numpy``."""

from vnl_tpu_torch.mjcf.compiler import (compile_numpy, compile_spec,
                                         load_model, load_spec)
from vnl_tpu_torch.mjcf.parser import MjcfElement, MjcfSpec, parse
from vnl_tpu_torch.mjcf.transforms import (rescale_subtree,
                                           to_torque_actuators)
