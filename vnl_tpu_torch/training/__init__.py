from vnl_tpu_torch.training import running_statistics
from vnl_tpu_torch.training.acting import (ActorStepGraph, Evaluator,
                                          actor_step, generate_unroll)
from vnl_tpu_torch.training.losses import (compute_gae,
                                          compute_ppo_intention_loss,
                                          kl_divergence)
from vnl_tpu_torch.training.train import TrainingState, train
from vnl_tpu_torch.training.types import Transition
