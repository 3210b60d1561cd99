"""The nn library of the port (the port of ``s2p_tpu/nn``): MLPs, conv
stacks, distributions, the Gaussian mixture, the linear transform,
initializers, the misc nets (spatial softmax, keypoint MLP, image/state
switches, pretrained-feature head) and the RAD augmentations
(``nn.augmentations``)."""

from s2p_tpu_torch.nn.initializers import (fanin_uniform_, scaled_orthogonal_, uniform_bias,
                                           xavier_uniform_)
from s2p_tpu_torch.nn.linear_transform import LinearTransform
from s2p_tpu_torch.nn.mixture import GaussianMixture
from s2p_tpu_torch.nn.mlp import ConcatMlp, Mlp, MultiHeadedMlp
from s2p_tpu_torch.nn.cnn import CNN, DCNN, ConvTranspose2dTorch
from s2p_tpu_torch.nn.distributions import Delta, Normal, TanhNormal
from s2p_tpu_torch.nn.misc_nets import (
    FeatPointMlp,
    ImageStatePolicy,
    ImageStateQ,
    PretrainedCNN,
    SpatialSoftmaxEncoder,
    spatial_softmax,
)

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
    "FeatPointMlp",
    "ImageStatePolicy",
    "ImageStateQ",
    "PretrainedCNN",
    "SpatialSoftmaxEncoder",
    "spatial_softmax",
]
