"""VGG19 perceptual loss (SPADE lineage) and LPIPS over VGG16.

The port of ``s2p_tpu/gan/perceptual.py``:

- the VGG19 loss compares relu1_1..relu5_1 activations with weights [1/32,
  1/16, 1/8, 1/4, 1];
- ``LPIPSMetric`` (Zhang et al. 2018) compares VGG16's relu1_2..relu5_3
  activations, each unit-normalised over channels (``x·rsqrt(Σx² +
  1e-10)``), squared, weighted over channels by the learned ``lin`` layers
  (``load_lpips_linear``) or, without them, averaged (uniform 1/C:
  uncalibrated), then averaged over space and summed over layers.

torchvision is not used: ``VGG19Features`` and ``VGG16Features`` are defined
here, with convs named ``conv{li}`` after torchvision's ``features.{li}``,
and ``load_torch_vgg19``/``load_torch_vgg16`` rename a torchvision state
dict into them. Without such weights each network is a fixed-seed random
one, as in the JAX package: random VGG features are a usable perceptual
distance, but not the published LPIPS.

Images enter NHWC in [-1, 1] and are shifted inside (ImageNet-normalised
RGB for VGG19, LPIPS's ScalingLayer for VGG16); the feature maps come back
NHWC. Inside, tensors are NCHW in channels_last memory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
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

# torchvision vgg16.features conv indices per LPIPS slice: relu1_2, relu2_2,
# relu3_3, relu4_3, relu5_3
_VGG16_SLICES: Sequence[Sequence[int]] = (
    (0, 2),
    (5, 7),
    (10, 12, 14),
    (17, 19, 21),
    (24, 26, 28),
)
_VGG16_CHANNELS: Dict[int, int] = {
    0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256,
    17: 512, 19: 512, 21: 512, 24: 512, 26: 512, 28: 512,
}
_VGG16_POOL_BEFORE = frozenset({5, 10, 17, 24})

# the official LPIPS ScalingLayer (inputs in [-1, 1])
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class _VGGPyramid(nn.Module):
    """3×3 convs ``conv{li}`` with ReLUs and 2×2 max pools, returning the
    activation at the end of each slice; the input is ``prepare(x)``, by
    default ``(x − shift) / scale``. Weights: flax-style seeded init
    (``seed``), frozen; built on ``device``, the card unless the caller asks
    otherwise."""

    def __init__(self, channels: Mapping[int, int], slices: Sequence[Sequence[int]],
                 pool_before: frozenset, shift, scale, seed: int,
                 device: str | torch.device):
        super().__init__()
        self.slices, self.pool_before = slices, pool_before
        c_prev = 3
        for li, c in channels.items():
            self.add_module(f"conv{li}", nn.Conv2d(c_prev, c, 3, padding=1))
            c_prev = c
        init_flax_style_(self, seed)
        self.requires_grad_(False)
        self.register_buffer("shift", torch.tensor(shift), persistent=False)
        self.register_buffer("scale", torch.tensor(scale), persistent=False)
        self.to(device=device, memory_format=CL)

    def prepare(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.prepare(x).permute(0, 3, 1, 2)
        feats = []
        for slice_layers in self.slices:
            for li in slice_layers:
                if li in self.pool_before:
                    h = F.max_pool2d(h, 2, 2)
                h = F.relu(getattr(self, f"conv{li}")(h))
            feats.append(h.permute(0, 2, 3, 1))
        return feats


class VGG19Features(_VGGPyramid):
    """relu{1..5}_1 feature pyramid of VGG19 over NHWC images in [-1, 1],
    ImageNet-normalised inside."""

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__(_VGG19_CHANNELS, _VGG19_SLICES, _POOL_BEFORE, _IMAGENET_MEAN,
                         _IMAGENET_STD, seed, device)

    def prepare(self, x: torch.Tensor) -> torch.Tensor:
        return ((x + 1.0) * 0.5 - self.shift) / self.scale


class VGG16Features(_VGGPyramid):
    """LPIPS's VGG16 pyramid (relu1_2..relu5_3) over NHWC images in [-1, 1],
    scaled by LPIPS's ScalingLayer."""

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__(_VGG16_CHANNELS, _VGG16_SLICES, _VGG16_POOL_BEFORE, _LPIPS_SHIFT,
                         _LPIPS_SCALE, seed, device)


def _load_torch_vgg(state_dict: Mapping[str, Any], channels) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for li in channels:
        for leaf in ("weight", "bias"):
            out[f"conv{li}.{leaf}"] = torch.as_tensor(
                state_dict[f"features.{li}.{leaf}"]).float()
    return out


def load_torch_vgg19(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision vgg19 ``state_dict`` (``features.{li}.weight/bias``,
    tensors or numpy arrays) → the state dict of ``VGG19Features``."""
    return _load_torch_vgg(state_dict, _VGG19_CHANNELS)


def load_torch_vgg16(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision vgg16 ``state_dict`` → the state dict of
    ``VGG16Features``."""
    return _load_torch_vgg(state_dict, _VGG16_CHANNELS)


def load_lpips_linear(state_dict: Mapping[str, Any]) -> List[np.ndarray]:
    """The official LPIPS lin layers (``lin{k}.model.1.weight``, [1, C, 1,
    1]) → one f32 channel-weight vector per slice."""
    return [np.asarray(state_dict[f"lin{k}.model.1.weight"]).reshape(-1).astype(np.float32)
            for k in range(len(_VGG16_SLICES))]


@torch.no_grad()
def pair_distance(vgg: _VGGPyramid, a, b,
                  channel_reduce: Callable[[int, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Σ_k mean_hw(channel_reduce(k, (F̂_k(a) − F̂_k(b))²)) per pair of NHWC
    images in [-1, 1] (arrays or tensors), F̂_k the ``vgg`` slice k
    unit-normalised over channels as ``x·rsqrt(Σx² + 1e-10)``. Both sides go
    through ``vgg`` as one batch, on its device and in its dtype."""
    a = torch.as_tensor(a, device=vgg.shift.device).to(vgg.shift.dtype)
    b = torch.as_tensor(b, device=a.device).to(a.dtype)
    n, total = a.shape[0], 0.0
    for k, f in enumerate(vgg(torch.cat([a, b]))):
        f = f * torch.rsqrt((f ** 2).sum(-1, keepdim=True) + 1e-10)
        total = total + channel_reduce(k, (f[:n] - f[n:]) ** 2).mean(dim=(-2, -1))
    return total


class LPIPSMetric:
    """LPIPS(VGG16) per image pair. ``state_dict``: ``VGG16Features``
    weights (``load_torch_vgg16``), else the seeded random network;
    ``lin_weights``: ``load_lpips_linear``'s vectors, else uniform 1/C
    (``calibrated`` False)."""

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 lin_weights: Optional[Sequence[np.ndarray]] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.vgg = VGG16Features(seed=seed, device=device)
        if state_dict is not None:
            self.vgg.load_state_dict(state_dict, strict=True)
        self.calibrated = lin_weights is not None
        self.lin_weights = None if lin_weights is None else [
            torch.as_tensor(np.asarray(w, np.float32), device=self.vgg.shift.device)
            for w in lin_weights]

    def _reduce(self, k: int, d2: torch.Tensor) -> torch.Tensor:
        if self.lin_weights is None:
            return d2.mean(-1)
        return (d2 * self.lin_weights[k]).sum(-1)

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Distances [B] of NHWC image pairs in [-1, 1], in the network's
        dtype."""
        return pair_distance(self.vgg, a, b, self._reduce)


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
