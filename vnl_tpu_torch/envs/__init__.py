from vnl_tpu_torch.envs.base import PipelineEnv, State
from vnl_tpu_torch.envs.rodent import RodentTracking, make_twin_env
from vnl_tpu_torch.envs.wrappers import (AutoResetWrapper, EpisodeWrapper,
                                        EvalWrapper, Wrapper,
                                        wrap_for_training)
