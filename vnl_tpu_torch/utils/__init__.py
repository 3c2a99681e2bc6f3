"""Config and logging utilities of the port (copies of vnl_tpu/utils'; they
import no JAX)."""

from vnl_tpu_torch.utils.config import apply_overrides, load_config
from vnl_tpu_torch.utils.logging import MetricsLogger
