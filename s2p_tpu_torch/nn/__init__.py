"""The nn library of the port: MLPs, conv stacks, distributions, the
Gaussian mixture, the linear transform and initializers (the port of
``s2p_tpu/nn``'s modules that SLAC and the RL trainers use)."""

from s2p_tpu_torch.nn.initializers import (fanin_uniform_, scaled_orthogonal_, uniform_bias,
                                           xavier_uniform_)
from s2p_tpu_torch.nn.linear_transform import LinearTransform
from s2p_tpu_torch.nn.mixture import GaussianMixture
from s2p_tpu_torch.nn.mlp import ConcatMlp, Mlp, MultiHeadedMlp
from s2p_tpu_torch.nn.cnn import CNN, DCNN, ConvTranspose2dTorch
from s2p_tpu_torch.nn.distributions import Delta, Normal, TanhNormal

__all__ = [
    "fanin_uniform_",
    "scaled_orthogonal_",
    "uniform_bias",
    "xavier_uniform_",
    "Mlp",
    "ConcatMlp",
    "MultiHeadedMlp",
    "CNN",
    "DCNN",
    "ConvTranspose2dTorch",
    "Normal",
    "TanhNormal",
    "Delta",
    "GaussianMixture",
    "LinearTransform",
]
