"""VGG19 perceptual loss (SPADE lineage).

The port of the VGG19 part of ``s2p_tpu/gan/perceptual.py``: the loss
compares relu1_1..relu5_1 activations with weights [1/32, 1/16, 1/8, 1/4,
1]. torchvision is not used: ``VGG19Features`` is defined here, with convs
named ``conv{li}`` after torchvision's ``features.{li}``, and
``load_torch_vgg19`` renames a torchvision ``vgg19`` state dict into it.
Without such weights the network is a fixed-seed random one, as in the JAX
package: random VGG features are a usable perceptual distance.

Images enter NHWC in [-1, 1] and are shifted to ImageNet-normalised RGB
inside; the feature maps come back NHWC. Inside, tensors are NCHW in
channels_last memory.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.gan.generator import CL, init_flax_style_

# torchvision vgg19.features conv indices, grouped by slice: slice k holds
# the convs up to and including relu{k}_1
_VGG19_SLICES: Sequence[Sequence[int]] = (
    (0,),
    (2, 5),
    (7, 10),
    (12, 14, 16, 19),
    (21, 23, 25, 28),
)
_VGG19_CHANNELS: Dict[int, int] = {
    0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256, 16: 256,
    19: 512, 21: 512, 23: 512, 25: 512, 28: 512,
}
# convs that torchvision's 2×2 max pool precedes
_POOL_BEFORE = frozenset({5, 10, 19, 28})

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class VGG19Features(nn.Module):
    """relu{1..5}_1 feature pyramid of VGG19 over NHWC images in [-1, 1].

    Weights: flax-style seeded init (``seed``), frozen; the module is built
    on ``device``, the card unless the caller asks otherwise."""

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        c_prev = 3
        for li, c in _VGG19_CHANNELS.items():
            self.add_module(f"conv{li}", nn.Conv2d(c_prev, c, 3, padding=1))
            c_prev = c
        init_flax_style_(self, seed)
        self.requires_grad_(False)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD), persistent=False)
        self.to(device=device, memory_format=CL)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = ((x + 1.0) * 0.5 - self.mean) / self.std
        h = x.permute(0, 3, 1, 2)
        feats = []
        for slice_layers in _VGG19_SLICES:
            for li in slice_layers:
                if li in _POOL_BEFORE:
                    h = F.max_pool2d(h, 2, 2)
                h = F.relu(getattr(self, f"conv{li}")(h))
            feats.append(h.permute(0, 2, 3, 1))
        return feats


def load_torch_vgg19(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision vgg19 ``state_dict`` (``features.{li}.weight/bias``,
    tensors or numpy arrays) → the state dict of ``VGG19Features``."""
    out: Dict[str, torch.Tensor] = {}
    for li in _VGG19_CHANNELS:
        for leaf in ("weight", "bias"):
            out[f"conv{li}.{leaf}"] = torch.as_tensor(
                state_dict[f"features.{li}.{leaf}"]).float()
    return out


class PerceptualLoss(nn.Module):
    """L = Σ_k w_k · mean|F_k(x) − F_k(y)| over the VGG19 slices; y is
    detached. ``state_dict``: VGG19Features weights (e.g. from
    ``load_torch_vgg19``); without it, the seeded random network."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor] | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.vgg = VGG19Features(seed=seed, device=device)
        if state_dict is not None:
            self.vgg.load_state_dict(state_dict, strict=True)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.vgg(x)
        fy = self.vgg(y.detach())
        loss = 0.0
        for w, a, b in zip(SLICE_WEIGHTS, fx, fy):
            loss = loss + w * (a - b.detach()).abs().mean()
        return loss
