"""Misc network components: the port of ``s2p_tpu/nn/misc_nets.py``.

- ``spatial_softmax``: NHWC feature maps → a softmax over H·W per channel
  (divided by the temperature) → the expected (x, y) of each channel on
  ``linspace(−1, 1)`` grids, ``[ex ‖ ey]`` with x first.
- ``SpatialSoftmaxEncoder``/``FeatPointMlp`` (rlkit's
  ``feat_point_mlp.py``): 5×5 VALID convs (48, stride 2; 48; the keypoint
  channels) → spatial softmax → an Mlp decoder (400, 300) to a
  downsampled image, reshaped NHWC.
- ``ImageStatePolicy``/``ImageStateQ`` (rlkit's ``image_state.py``): route
  a flat [image ‖ state] input (``image_dim`` 21,168 = 84·84·3) to exactly
  one of two towers.
- ``PretrainedCNN`` (rlkit's ``pretrained_cnn.py``): a feature function,
  frozen by a ``detach``, flattened into an Mlp ``head``. The feature
  function is the caller's and is not a submodule, as in the JAX package,
  where it is a bound apply outside the parameter tree; PyTorch needs the
  head's fan-in, ``feature_size``, when it is built.

Images are NHWC at the API; the convs run NCHW inside. Module names are
flax's (``conv1..3``, ``encoder``, ``decoder``, ``head``, ``image_net``,
``state_net``), so ``state_dict_from_jax_misc_params`` carries a JAX tree
over. Weights come from ``gen`` (a CPU ``torch.Generator``, or one seeded
from ``seed``): LeCun-normal conv kernels and zero biases as flax's
defaults, the port's Mlp init elsewhere. Modules are built on the CPU and
moved to ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict, state_dict_from_jax_dense_tree
from s2p_tpu_torch.nn.initializers import lecun_normal_
from s2p_tpu_torch.nn.mlp import Mlp, init_generator


def spatial_softmax(features: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """NHWC feature maps → [B, 2·C] expected (x, y) keypoints."""
    B, H, W, C = features.shape
    flat = features.reshape(B, H * W, C) / temperature
    probs = torch.softmax(flat, dim=1).reshape(B, H, W, C)
    ys = torch.linspace(-1.0, 1.0, H, device=features.device)[None, :, None, None]
    xs = torch.linspace(-1.0, 1.0, W, device=features.device)[None, None, :, None]
    ey = (probs * ys).sum(dim=(1, 2))
    ex = (probs * xs).sum(dim=(1, 2))
    return torch.cat([ex, ey], dim=-1)


def _conv(c_in: int, c_out: int, stride: int, gen: torch.Generator) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, 5, stride=stride)
    lecun_normal_(conv.weight, gen)
    nn.init.zeros_(conv.bias)
    return conv


class SpatialSoftmaxEncoder(nn.Module):
    def __init__(self, num_feat_points: int, input_channels: int = 3, temperature: float = 1.0,
                 gen: Optional[torch.Generator] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        gen = init_generator(gen, seed)
        self.temperature = temperature
        self.conv1 = _conv(input_channels, 48, 2, gen)
        self.conv2 = _conv(48, 48, 1, gen)
        self.conv3 = _conv(48, num_feat_points, 1, gen)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1(x.permute(0, 3, 1, 2)))
        h = F.relu(self.conv2(h))
        h = self.conv3(h).permute(0, 2, 3, 1)
        return spatial_softmax(h, self.temperature)


class FeatPointMlp(nn.Module):
    """Keypoint autoencoder: ``forward`` → [B, d, d, C]; ``encode`` → the
    keypoints [B, 2·num_feat_points]."""

    def __init__(self, num_feat_points: int, input_channels: int = 3, downsample_size: int = 8,
                 temperature: float = 1.0, gen: Optional[torch.Generator] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        gen = init_generator(gen, seed)
        self.input_channels, self.downsample_size = input_channels, downsample_size
        self.encoder = SpatialSoftmaxEncoder(num_feat_points, input_channels, temperature,
                                             gen=gen, device="cpu")
        d = downsample_size
        self.decoder = Mlp(2 * num_feat_points, (400, 300), input_channels * d * d, gen=gen)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.downsample_size
        return self.decoder(self.encoder(x)).reshape(-1, d, d, self.input_channels)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


def _one_tower(image_net, state_net) -> None:
    if (image_net is None) == (state_net is None):
        raise ValueError("give exactly one of image_net and state_net")


class ImageStatePolicy(nn.Module):
    """``image_net(x[:, :image_dim])`` or ``state_net(x[:, image_dim:])``."""

    def __init__(self, image_net: Optional[nn.Module] = None,
                 state_net: Optional[nn.Module] = None, image_dim: int = 21168):
        super().__init__()
        _one_tower(image_net, state_net)
        self.image_net, self.state_net, self.image_dim = image_net, state_net, image_dim

    def forward(self, x: torch.Tensor):
        if self.image_net is not None:
            return self.image_net(x[:, : self.image_dim])
        return self.state_net(x[:, self.image_dim:])


class ImageStateQ(nn.Module):
    """The Q form: the routed part of ``x`` concatenated with the action."""

    def __init__(self, image_net: Optional[nn.Module] = None,
                 state_net: Optional[nn.Module] = None, image_dim: int = 21168):
        super().__init__()
        _one_tower(image_net, state_net)
        self.image_net, self.state_net, self.image_dim = image_net, state_net, image_dim

    def forward(self, x: torch.Tensor, action: torch.Tensor):
        if self.image_net is not None:
            return self.image_net(torch.cat([x[:, : self.image_dim], action], dim=-1))
        return self.state_net(torch.cat([x[:, self.image_dim:], action], dim=-1))


class PretrainedCNN(nn.Module):
    def __init__(self, feature_fn: Callable, feature_size: int, hidden_sizes: Sequence[int],
                 output_size: int, freeze_features: bool = True,
                 gen: Optional[torch.Generator] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        object.__setattr__(self, "feature_fn", feature_fn)  # not a submodule
        self.freeze_features = freeze_features
        self.head = Mlp(feature_size, hidden_sizes, output_size, gen=init_generator(gen, seed))
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.feature_fn(x)
        if self.freeze_features:
            feat = feat.detach()
        return self.head(feat.reshape(feat.shape[0], -1))


def state_dict_from_jax_misc_params(params: Mapping) -> dict:
    """A JAX tree of any module above (``{"params": ...}``, numpy leaves) as
    the port's state dict."""
    return state_dict_from_jax_dense_tree(params)


def jax_misc_params_from_state_dict(sd: Mapping) -> dict:
    return jax_dense_tree_from_state_dict(sd)
