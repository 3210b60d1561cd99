"""Pixel encoder and encoder-wrapped heads: the CURL/RAD image-RL path.

The port of ``s2p_tpu/rl/encoders.py``:

- ``PixelEncoder``: the CURL conv stem, a 3×3 stride-2 conv then
  ``num_layers − 1`` 3×3 stride-1 convs (VALID, ReLU), flattened in NHWC's
  (H, W, C) order, then ``fc`` → LayerNorm (ε 1e-6) → tanh. ``detach``
  stops the gradient after the flatten: the convs get none, ``fc`` and
  ``ln`` still do. PyTorch needs ``fc``'s fan-in when it is built, so the
  encoder takes the observation's (H, W, C) and sizes the stack with
  ``data.loaders.conv_stack_output_shape`` (the ``OUT_DIM_*`` tables).
- ``EncoderQfunction``/``EncoderVFunction``: an Mlp ``head`` over the
  features (and the action).
- ``EncoderCritic``: twin Qs over ONE shared ``encoder`` (``qf1.head``,
  ``qf2.head``), as the JAX tree hoists it; the features are computed once
  for both heads.
- ``TanhGaussianPolicyWithEncoder``: encoder → ``TanhGaussianPolicy``
  ``head``; the encoder is detached by default (the critic trains it).
- ``CURL``: logits[i, j] = z_a[i]·W·z_pos[j] with ``z_pos`` detached, rows
  max-subtracted; ``curl_loss`` is InfoNCE with the diagonal as labels.

Observations are NHWC floats in [0, 1]. Module and parameter names are
the flax tree's (``encoder/conv{i}, fc, ln``, ``head/...``, ``W``), so
``state_dict_from_jax_encoder_params`` carries a JAX tree over. Weights come
from ``gen`` (a CPU ``torch.Generator``, or one seeded from ``seed``): flax's
defaults, LeCun-normal kernels and zero biases for the encoder, the Mlp and
policy inits for the heads, N(0, 1) for ``W``. Modules are built on the CPU
and moved to ``device`` (the card unless the caller asks for the CPU); the
heads follow their encoder's device.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.data.loaders import conv_stack_output_shape
from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict, state_dict_from_jax_dense_tree
from s2p_tpu_torch.nn.distributions import TanhNormal
from s2p_tpu_torch.nn.initializers import lecun_normal_
from s2p_tpu_torch.nn.mlp import LAYER_NORM_EPS, Mlp, init_generator
from s2p_tpu_torch.rl.policies import TanhGaussianPolicy

# conv output sizes of the 4-layer stride (2, 1, 1, 1) CURL stem, by input
# size and layer count (reference custom_networks.py:4-11)
OUT_DIM_64 = {2: 29, 4: 25, 6: 21}
OUT_DIM_84 = {2: 39, 4: 35, 6: 31}
OUT_DIM_100 = {2: 47, 4: 43, 6: 39}
OUT_DIM_128 = {2: 61, 4: 57, 6: 53}


def pixel_encoder_out_hw(hw: int, num_layers: int) -> int:
    """The stem's output side for an ``hw`` × ``hw`` input."""
    return conv_stack_output_shape(hw, [3] * num_layers, [2] + [1] * (num_layers - 1),
                                   [0] * num_layers)


class PixelEncoder(nn.Module):
    def __init__(self, obs_shape: Tuple[int, int, int], feature_dim: int = 50,
                 num_layers: int = 4, num_filters: int = 32,
                 gen: Optional[torch.Generator] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        gen = init_generator(gen, seed)
        H, W, C = obs_shape
        self.feature_dim, self.num_layers = feature_dim, num_layers
        for i in range(num_layers):
            conv = nn.Conv2d(C if i == 0 else num_filters, num_filters, 3,
                             stride=2 if i == 0 else 1)
            lecun_normal_(conv.weight, gen)
            nn.init.zeros_(conv.bias)
            self.add_module(f"conv{i}", conv)
        self.out_hw = (pixel_encoder_out_hw(H, num_layers), pixel_encoder_out_hw(W, num_layers))
        self.fc = nn.Linear(self.out_hw[0] * self.out_hw[1] * num_filters, feature_dim)
        lecun_normal_(self.fc.weight, gen)
        nn.init.zeros_(self.fc.bias)
        self.ln = nn.LayerNorm(feature_dim, eps=LAYER_NORM_EPS)
        self.to(device)

    def forward(self, obs: torch.Tensor, detach: bool = False) -> torch.Tensor:
        h = obs.permute(0, 3, 1, 2)
        for i in range(self.num_layers):
            h = F.relu(getattr(self, f"conv{i}")(h))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flax's (H, W, C) order
        if detach:
            h = h.detach()
        return torch.tanh(self.ln(self.fc(h)))


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


class EncoderQfunction(nn.Module):
    """Q(encode(obs), action). Inside ``EncoderCritic`` its ``encoder`` is
    None: the critic owns the shared one and calls ``q`` on its features."""

    def __init__(self, encoder: Optional[PixelEncoder], action_dim: int,
                 hidden_sizes: Sequence[int] = (1024, 1024), feature_dim: Optional[int] = None,
                 gen: Optional[torch.Generator] = None, seed: int = 0,
                 device: Optional[str | torch.device] = None):
        super().__init__()
        self.encoder = encoder
        feature_dim = encoder.feature_dim if encoder is not None else feature_dim
        self.head = Mlp(feature_dim + action_dim, hidden_sizes, 1, gen=init_generator(gen, seed))
        self.head.to(device if encoder is None else _device_of(encoder))

    def q(self, feat: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.head(torch.cat([feat, action], dim=-1))

    def forward(self, obs: torch.Tensor, action: torch.Tensor,
                detach_encoder: bool = False) -> torch.Tensor:
        return self.q(self.encoder(obs, detach=detach_encoder), action)


class EncoderVFunction(nn.Module):
    """V(encode(obs))."""

    def __init__(self, encoder: PixelEncoder, hidden_sizes: Sequence[int] = (1024, 1024),
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        self.encoder = encoder
        self.head = Mlp(encoder.feature_dim, hidden_sizes, 1, gen=init_generator(gen, seed))
        self.head.to(_device_of(encoder))

    def forward(self, obs: torch.Tensor, detach_encoder: bool = False) -> torch.Tensor:
        return self.head(self.encoder(obs, detach=detach_encoder))


class EncoderCritic(nn.Module):
    """Twin Q over one shared encoder: ``forward`` → (q1, q2)."""

    def __init__(self, encoder: PixelEncoder, action_dim: int,
                 hidden_sizes: Sequence[int] = (1024, 1024),
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        gen = init_generator(gen, seed)
        self.encoder = encoder
        kw = dict(hidden_sizes=hidden_sizes, feature_dim=encoder.feature_dim, gen=gen,
                  device=_device_of(encoder))
        self.qf1 = EncoderQfunction(None, action_dim, **kw)
        self.qf2 = EncoderQfunction(None, action_dim, **kw)

    def forward(self, obs: torch.Tensor, action: torch.Tensor, detach_encoder: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.encoder(obs, detach=detach_encoder)
        return self.qf1.q(feat, action), self.qf2.q(feat, action)


class TanhGaussianPolicyWithEncoder(nn.Module):
    def __init__(self, encoder: PixelEncoder, action_dim: int,
                 hidden_sizes: Sequence[int] = (1024, 1024),
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        self.encoder = encoder
        self.head = TanhGaussianPolicy(encoder.feature_dim, hidden_sizes, action_dim,
                                       gen=init_generator(gen, seed))
        self.head.to(_device_of(encoder))

    def forward(self, obs: torch.Tensor, detach_encoder: bool = True) -> TanhNormal:
        return self.head(self.encoder(obs, detach=detach_encoder))


class CURL(nn.Module):
    def __init__(self, encoder: PixelEncoder, gen: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__()
        gen = init_generator(gen, seed)
        self.encoder = encoder
        d = encoder.feature_dim
        self.W = nn.Parameter(torch.randn((d, d), generator=gen).to(_device_of(encoder)))

    def forward(self, obs_anchor: torch.Tensor, obs_pos: torch.Tensor) -> torch.Tensor:
        z_a = self.encoder(obs_anchor)
        z_pos = self.encoder(obs_pos).detach()
        logits = z_a @ self.W @ z_pos.T
        return logits - logits.max(dim=1, keepdim=True).values


def curl_loss(logits: torch.Tensor) -> torch.Tensor:
    """InfoNCE with diagonal labels: the mean of −log_softmax's diagonal."""
    return -torch.log_softmax(logits, dim=1).diagonal().mean()


def state_dict_from_jax_encoder_params(params: Mapping) -> dict:
    """A JAX tree of any module above (``{"params": ...}``, numpy leaves:
    ``encoder`` with ``qf1/head``, ``qf2/head``, ``head`` or ``W``) as the
    port's state dict."""
    return state_dict_from_jax_dense_tree(params)


def jax_encoder_params_from_state_dict(sd: Mapping) -> dict:
    return jax_dense_tree_from_state_dict(sd)
