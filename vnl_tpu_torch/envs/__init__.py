from vnl_tpu_torch.envs.ant import AntTracking, make_still_clip
from vnl_tpu_torch.envs.base import (PipelineEnv, State, StateGraph,
                                     step_in_place)
from vnl_tpu_torch.envs.humanoid import HumanoidStanding, HumanoidTracking
from vnl_tpu_torch.envs.registry import get_environment, register_environment
from vnl_tpu_torch.envs.rodent import (RodentMultiClipTracking,
                                       RodentTracking, compile_rodent,
                                       make_twin_env)
from vnl_tpu_torch.envs.wrappers import (AutoResetWrapper, EpisodeWrapper,
                                        EvalWrapper, Wrapper,
                                        wrap_for_training)
