from vnl_tpu_torch.envs.base import PipelineEnv, State
from vnl_tpu_torch.envs.rodent import RodentTracking, make_twin_env
