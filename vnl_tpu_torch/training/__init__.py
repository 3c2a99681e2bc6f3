from vnl_tpu_torch.training.acting import (Transition, actor_step,
                                          generate_unroll)
