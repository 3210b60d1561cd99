"""InceptionV3 pool3 features for FID.

The port of ``s2p_tpu/gan/inception.py``. torchvision is not used:

- ``InceptionV3Features`` is torchvision's ``inception_v3`` topology up to
  the global-average pool3 features [B, 2048], inference only, with
  torchvision's module names (``Mixed_5b.branch1x1``, …); each
  ``BasicConv2d`` is a bias-free conv, its BatchNorm folded into a
  per-channel affine (``bn_scale``, ``bn_offset``), and a ReLU. Images
  enter NHWC in [−1, 1] (``transform_input`` off, as pytorch-fid uses
  torchvision's weights); inside, tensors are NCHW in channels_last memory.
- ``load_torch_inception_v3`` folds a torchvision state dict's BatchNorms
  with their ε 1e-3 into that affine.
- ``resize_bilinear`` is ``jax.image.resize(..., "bilinear")``: half-pixel
  centres, and a triangle filter widened by the scale when it downsamples
  (antialiasing), computed as JAX computes it: one weight matrix per
  spatial axis, contracted with the images. The weights are JAX's jitted
  f32 ones, built on the host step by step in f32 with the sample position
  ``(i + 0.5)·(1/scale) − 0.5`` as one fused multiply-add, as XLA's CPU
  code computes it: positions near 300 round by ~3e-5 in f32, so JAX's
  resize is 6e-5 off an exact one at 320² → 299², and
  ``F.interpolate(mode="bilinear", antialias=True)``, the same filter with
  its own f32 rounding, lands 3e-5 off JAX's.
- ``inception_fid_extractor`` resizes to 299² and returns pool3 features
  for ``compute_fid``.

The three-pixel average pools count the padding; the max pools have none.
Without converted weights the network is a fixed-seed random one (LeCun
normal kernels, unit scales, zero offsets, as flax initialises the JAX
module): a self-consistent FID, not the published one.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.gan.convert import state_dict_from_jax_params
from s2p_tpu_torch.gan.generator import CL
from s2p_tpu_torch.nn.initializers import lecun_normal_

BN_EPS = 1e-3  # torchvision BasicConv2d's BatchNorm
INCEPTION_SIZE = 299

Pad = int | Tuple[int, int]


class BasicConv2d(nn.Module):
    """conv (no bias) → folded BatchNorm affine → ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel: Pad, stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(c_out))
        self.bn_offset = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x) * self.bn_scale[:, None, None] + self.bn_offset[:, None, None])


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool3(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _max_pool3(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool3(x))], dim=1)


class InceptionV3Features(nn.Module):
    """torchvision ``inception_v3``'s stem and Mixed_5b..7c → pool3 [B, 2048]
    over NHWC images in [−1, 1] (75² at least; the extractor resizes to
    299²). Weights: seeded flax-style init (``seed``), frozen; built on
    ``device``, the card unless the caller asks otherwise."""

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("conv.weight"):
                lecun_normal_(p, gen)
        self.requires_grad_(False)
        self.to(device=device, memory_format=CL)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=CL)
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(h)))
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool3(h)))
        h = _max_pool3(h)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            h = getattr(self, f"Mixed_{name}")(h)
        return h.mean(dim=(2, 3))


def expected_torch_inception_keys() -> Sequence[str]:
    """The keys a torchvision ``inception_v3`` state dict must provide (to
    check a user's weight file)."""
    leaves = ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")
    with torch.device("meta"):  # names only: no weights are drawn
        net = InceptionV3Features(device="meta")
    return [f"{name}.{leaf}" for name, m in net.named_modules()
            if isinstance(m, BasicConv2d) for leaf in leaves]


def load_torch_inception_v3(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision ``inception_v3`` state dict (tensors or numpy arrays) →
    the state dict of ``InceptionV3Features``: per BasicConv2d ``m``, the
    conv weight as it is and ``bn_scale = γ/√(σ² + 1e-3)``, ``bn_offset = β −
    μ·bn_scale`` from the BatchNorm's running statistics, in f32 as the JAX
    package folds them. The classifier (``fc.*``), the auxiliary head
    (``AuxLogits.*``) and ``num_batches_tracked`` are ignored."""
    def arr(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    out: Dict[str, torch.Tensor] = {}
    for key in state_dict:
        if not key.endswith(".bn.running_var") or key.startswith(("fc.", "AuxLogits.")):
            continue
        m = key[:-len(".bn.running_var")]
        gamma, beta = arr(state_dict[f"{m}.bn.weight"]), arr(state_dict[f"{m}.bn.bias"])
        mean, var = arr(state_dict[f"{m}.bn.running_mean"]), arr(state_dict[key])
        scale = gamma / np.sqrt(var + BN_EPS)
        out[f"{m}.conv.weight"] = torch.tensor(arr(state_dict[f"{m}.conv.weight"]),
                                               dtype=torch.float32)
        out[f"{m}.bn_scale"] = torch.tensor(scale, dtype=torch.float32)
        out[f"{m}.bn_offset"] = torch.tensor(beta - mean * scale, dtype=torch.float32)
    return out


# the JAX InceptionV3Features params tree (numpy leaves; HWIO kernels,
# bn_scale/bn_offset) → the port's state dict
state_dict_from_jax_inception_params = state_dict_from_jax_params


@functools.lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32 weights of the antialiased triangle filter along
    one axis: ``jax.image.scale.compute_weight_mat`` with the bilinear
    kernel and no translation, step by step in f32 as jitted JAX runs it
    (the sample position's product and sum fused: exact in f64, one f32
    rounding)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    half_steps = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (half_steps.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    dist = np.abs(sample[:, None] - np.arange(n_in, dtype=f32)[None, :]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(dist))
    total = w.sum(axis=1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(f32)


def resize_bilinear(images: torch.Tensor, size: int = INCEPTION_SIZE) -> torch.Tensor:
    """NHWC images → NHWC ``size``², as ``jax.image.resize(..., "bilinear")``
    (half-pixel centres; antialiased when it downsamples)."""
    _, h, w, _ = images.shape
    weight = lambda n: torch.tensor(resize_weights(n, size), dtype=images.dtype,  # noqa: E731
                                    device=images.device)
    return torch.einsum("oh,bhwc,pw->bopc", weight(h), images, weight(w))


def inception_fid_extractor(state_dict: Mapping[str, torch.Tensor] | None = None, seed: int = 0,
                            device: str | torch.device = "cuda"
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """pool3 extractor for ``compute_fid`` (NHWC in [−1, 1], any size ≥ 1):
    the given weights (``load_torch_inception_v3``) or the seeded random
    network."""
    net = InceptionV3Features(seed=seed, device=device)
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)

    @torch.no_grad()
    def extract(images: torch.Tensor) -> torch.Tensor:
        images = torch.as_tensor(images, device=net.Conv2d_1a_3x3.bn_scale.device).float()
        return net(resize_bilinear(images))

    return extract
