"""The offline-RL networks and trainers (the port of ``s2p_tpu/rl``'s
policies, critics, samplers, IQL, SAC, CQL, the VAE policy and the CURL
pixel encoders)."""

from s2p_tpu_torch.rl.policies import (
    GaussianPolicy,
    TanhGaussianPolicy,
    jax_policy_params_from_state_dict,
    make_deterministic,
    state_dict_from_jax_policy_params,
)
from s2p_tpu_torch.rl.critics import (
    CriticSLAC,
    Qfunction,
    Vfunction,
    jax_critic_params_from_state_dict,
    q_subtree,
    soft_update,
    state_dict_from_jax_critic_params,
)
from s2p_tpu_torch.rl.iql import IQLTrainer, iql_full_state_from_jax, jax_iql_full_state
from s2p_tpu_torch.rl.sac import SACTrainer
from s2p_tpu_torch.rl.cql import CQLTrainer, cql_full_state_from_jax, jax_cql_full_state
from s2p_tpu_torch.rl.scan_utils import make_flat_sampler, make_window_sampler, train_many_dp
from s2p_tpu_torch.rl.vae_policy import (
    PolicyFromQ,
    VAEPolicy,
    elbo_loss,
    state_dict_from_jax_vae_params,
)
from s2p_tpu_torch.rl.encoders import (
    CURL,
    EncoderCritic,
    EncoderQfunction,
    EncoderVFunction,
    PixelEncoder,
    TanhGaussianPolicyWithEncoder,
    curl_loss,
    jax_encoder_params_from_state_dict,
    state_dict_from_jax_encoder_params,
)

__all__ = [
    "GaussianPolicy",
    "TanhGaussianPolicy",
    "jax_policy_params_from_state_dict",
    "make_deterministic",
    "state_dict_from_jax_policy_params",
    "CriticSLAC",
    "Qfunction",
    "Vfunction",
    "jax_critic_params_from_state_dict",
    "q_subtree",
    "soft_update",
    "state_dict_from_jax_critic_params",
    "IQLTrainer",
    "iql_full_state_from_jax",
    "jax_iql_full_state",
    "SACTrainer",
    "CQLTrainer",
    "cql_full_state_from_jax",
    "jax_cql_full_state",
    "make_flat_sampler",
    "make_window_sampler",
    "train_many_dp",
    "PolicyFromQ",
    "VAEPolicy",
    "elbo_loss",
    "state_dict_from_jax_vae_params",
    "CURL",
    "EncoderCritic",
    "EncoderQfunction",
    "EncoderVFunction",
    "PixelEncoder",
    "TanhGaussianPolicyWithEncoder",
    "curl_loss",
    "jax_encoder_params_from_state_dict",
    "state_dict_from_jax_encoder_params",
]
