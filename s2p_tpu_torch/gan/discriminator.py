"""Multiscale PatchGAN discriminator.

The port of ``s2p_tpu/gan/discriminator.py``. Each scale is an N-layer
4×4 conv stack (pad 2) with affine-free instance norm and leaky-ReLU 0.2;
the input of scale k is scale k−1's input average-pooled by 2. D judges
(condition, image) pairs: the previous image and the spatially broadcast
state, concatenated with the image along channels.

Module names equal the flax tree (``scale{s}.conv{i}``,
``scale{s}.conv_out``), so a JAX ``params`` tree loads with
``strict=True`` through ``convert.state_dict_from_jax_params``. Images and
the returned feature maps are NHWC, as in the JAX package; inside, tensors
are NCHW in channels_last memory, so every NHWC view is free. The
instance norm is plain PyTorch ops (XLA in the JAX package), which R1's
double backward differentiates.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.gan.generator import CL, init_flax_style_, instance_norm


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 average pool with pad 1 over NCHW ``x``; edge windows
    average their valid pixels only (count_include_pad=False).

    The pool reads a contiguous NCHW copy and returns channels_last: on
    CUDA, PyTorch's channels_last backward of this pool returns wrong input
    gradients (relative error 1.05 against float64, PyTorch 2.11 with CUDA
    12.8 on an H100), which would corrupt R1 and every G gradient that
    passes through D's coarser scales."""
    out = F.avg_pool2d(x.contiguous(), 3, stride=2, padding=1, count_include_pad=False)
    return out.contiguous(memory_format=CL)


class NLayerDiscriminator(nn.Module):
    """One PatchGAN scale; returns [feat_0, ..., feat_{n-1}, logits] as
    NCHW tensors."""

    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 4):
        super().__init__()
        self.n_layers = n_layers
        c = ndf
        self.conv0 = nn.Conv2d(in_channels, c, 4, stride=2, padding=2)
        for i in range(1, n_layers):
            c_prev, c = c, min(c * 2, 512)
            stride = 2 if i < n_layers - 1 else 1
            self.add_module(f"conv{i}", nn.Conv2d(c_prev, c, 4, stride=stride, padding=2,
                                                  bias=False))
        self.conv_out = nn.Conv2d(c, 1, 4, padding=2)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.leaky_relu(self.conv0(x), 0.2)
        feats = [h]
        for i in range(1, self.n_layers):
            h = F.leaky_relu(instance_norm(getattr(self, f"conv{i}")(h)), 0.2)
            feats.append(h)
        feats.append(self.conv_out(h))
        return feats


class MultiscaleDiscriminator(nn.Module):
    """``num_scales`` PatchGANs over progressively pooled inputs.

    ``forward(state, prev_image, image)`` returns a list (per scale) of
    lists (per layer) of NHWC feature maps; the last entry of each inner
    list is the patch logit map. Weights are initialised as flax does (LeCun
    normal kernels, zero biases) from ``seed`` on the CPU, and the module is
    built on ``device``, the card unless the caller asks otherwise."""

    def __init__(self, state_dim: int, image_channels: int = 3, num_scales: int = 2,
                 ndf: int = 64, n_layers: int = 4, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.num_scales = num_scales
        in_ch = 2 * image_channels + state_dim
        for s in range(num_scales):
            self.add_module(f"scale{s}", NLayerDiscriminator(in_ch, ndf, n_layers))
        init_flax_style_(self, seed)
        self.to(device=device, memory_format=CL)

    def forward(self, state: torch.Tensor, prev_image: torch.Tensor,
                image: torch.Tensor) -> List[List[torch.Tensor]]:
        b, h, w, _ = image.shape
        state_map = state[:, None, None, :].expand(b, h, w, state.shape[-1])
        x = torch.cat([prev_image, state_map, image], dim=-1).permute(0, 3, 1, 2)
        outs = []
        for s in range(self.num_scales):
            feats = getattr(self, f"scale{s}")(x)
            outs.append([f.permute(0, 2, 3, 1) for f in feats])
            if s < self.num_scales - 1:
                x = avg_pool_2x(x)
        return outs
