"""Data parallelism of the port over torch.distributed (PyTorch
counterpart of vnl_tpu/parallel): one process per GPU, the gradient mean
and the normaliser's sums as all-reduces over the process group."""

from vnl_tpu_torch.parallel.distributed import initialize
from vnl_tpu_torch.parallel.mesh import (
    assert_is_replicated,
    create_mesh,
    data_parallel_specs,
    synchronize_hosts,
)
