"""The offline-RL networks and the IQL trainer (the port of ``s2p_tpu/rl``'s
policies, critics, samplers and IQL; CQL and SAC come later)."""

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
from s2p_tpu_torch.rl.scan_utils import make_flat_sampler, make_window_sampler

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
    "make_flat_sampler",
    "make_window_sampler",
]
