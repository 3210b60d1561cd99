"""SLAC: the sequential latent model, its algorithm wrapper, weight
converters, pretraining and the online actor-critic networks (the port of
``s2p_tpu/slac``)."""

from s2p_tpu_torch.slac.latent import (
    FixedGaussianParams,
    GaussianHead,
    LatentModel,
    SlacDecoder,
    SlacEncoder,
    calculate_kl_divergence,
    create_feature_actions,
)
from s2p_tpu_torch.slac.algo import SlacAlgorithm
from s2p_tpu_torch.slac.convert import (
    convert_latent_state_dict,
    jax_latent_params_from_state_dict,
    state_dict_from_jax_latent_params,
)
from s2p_tpu_torch.slac.networks import (
    SlacGaussianPolicy,
    TwinnedQNetwork,
    jax_slac_network_params_from_state_dict,
    state_dict_from_jax_slac_network_params,
)
from s2p_tpu_torch.slac.pretrain import pretrain_latent

__all__ = [
    "FixedGaussianParams",
    "GaussianHead",
    "LatentModel",
    "SlacDecoder",
    "SlacEncoder",
    "calculate_kl_divergence",
    "create_feature_actions",
    "SlacAlgorithm",
    "convert_latent_state_dict",
    "jax_latent_params_from_state_dict",
    "state_dict_from_jax_latent_params",
    "SlacGaussianPolicy",
    "TwinnedQNetwork",
    "jax_slac_network_params_from_state_dict",
    "state_dict_from_jax_slac_network_params",
    "pretrain_latent",
]
