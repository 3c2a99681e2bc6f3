from vnl_tpu_torch.models.distribution import NormalTanhDistribution
from vnl_tpu_torch.models.intention import IntentionPolicy
from vnl_tpu_torch.models.networks import MLP, make_value_network
from vnl_tpu_torch.models.ppo_networks import (PPOImitationNetworks,
                                               make_inference_fn,
                                               make_intention_ppo_networks)
