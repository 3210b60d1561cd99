"""RAD-style image augmentations over NHWC batches.

The port of ``s2p_tpu/nn/augmentations.py`` (the CURL/RAD augmentation zoo
of the reference's ``data_augs.py``): random crop and translate, grayscale,
cutout (zero or coloured), flip, rotation, random convolution, colour
jitter and no-op, each a batched function over a uint8 or float NHWC
tensor on any device, vectorized (no loop over the images).

Where the JAX function takes a PRNG key, the port takes a
``torch.Generator`` on the input's device (or ``None``, the device's
default generator). Every draw can also be given by keyword (offsets,
masks, rotation counts, cutout sizes and colour, convolution kernels,
jitter factors), which is how the tests hand over JAX's draws. Flip,
grayscale and rotation apply per image with probability ``p``; a mask is
``uniform < p``, JAX's Bernoulli.

The random convolution and the colour jitter scale by 1/255 as a product
with ``f32(1/255)`` (a tensor, so the card and the CPU agree): what XLA's
``jit`` makes of the JAX package's ``x / 255.0``. Casting back to uint8
truncates toward zero, as XLA's conversion does, on values ≥ 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_GRAY_W = (0.2989, 0.587, 0.114)


def _randint(generator, low: int, high: int, shape, device) -> torch.Tensor:
    """Integers from [low, high); ``low`` itself, with no draw, where the
    range is empty (``high ≤ low``), as ``jax.random.randint`` gives."""
    if high <= low:
        return torch.full(shape, low, dtype=torch.int64, device=device)
    return torch.randint(low, high, shape, generator=generator, device=device)


def _bernoulli(generator, p: float, n: int, device) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=device) < p


def _uniform(generator, low: float, high: float, shape, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return u * (high - low) + low


def _to_float01(imgs: torch.Tensor) -> torch.Tensor:
    return imgs.float() * torch.tensor(_INV_255, device=imgs.device)


def _from_float01(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (out * 255.0).to(dtype)


def random_crop(generator: Optional[torch.Generator], imgs: torch.Tensor, out: int = 84, *,
                h: Optional[torch.Tensor] = None, w: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """An ``out`` × ``out`` window per image at offsets ``h``, ``w`` drawn
    from [0, H − out] and [0, W − out]."""
    B, H, W, _ = imgs.shape
    if out > H or out > W:
        raise ValueError(f"crop {out} larger than the {H}x{W} images")
    dev = imgs.device
    h = _randint(generator, 0, H - out + 1, (B,), dev) if h is None else h.to(dev)
    w = _randint(generator, 0, W - out + 1, (B,), dev) if w is None else w.to(dev)
    r = torch.arange(out, device=dev)
    b = torch.arange(B, device=dev)[:, None, None]
    return imgs[b, (h[:, None] + r)[:, :, None], (w[:, None] + r)[:, None, :]]


def random_translate(generator: Optional[torch.Generator], imgs: torch.Tensor, size: int, *,
                     h: Optional[torch.Tensor] = None, w: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Each image placed at offsets ``h``, ``w`` on a zero ``size`` ×
    ``size`` canvas."""
    B, H, W, C = imgs.shape
    if size < H or size < W:
        raise ValueError(f"canvas {size} smaller than the {H}x{W} images")
    dev = imgs.device
    h = _randint(generator, 0, size - H + 1, (B,), dev) if h is None else h.to(dev)
    w = _randint(generator, 0, size - W + 1, (B,), dev) if w is None else w.to(dev)
    canvas = imgs.new_zeros((B, size, size, C))
    b = torch.arange(B, device=dev)[:, None, None]
    rows = (h[:, None] + torch.arange(H, device=dev))[:, :, None]
    cols = (w[:, None] + torch.arange(W, device=dev))[:, None, :]
    canvas[b, rows, cols] = imgs
    return canvas


def grayscale(imgs: torch.Tensor) -> torch.Tensor:
    """Luma (0.2989, 0.587, 0.114) over the three channels of RGB images, in
    f32, replicated to the three channels and cast back to the input's
    dtype. Any other channel count (a frame stack) raises, as JAX's
    contraction with three weights does."""
    if imgs.shape[-1] != 3:
        raise ValueError(f"grayscale takes 3 channels, got {imgs.shape[-1]}")
    f = imgs.float()
    g = f[..., 0] * _GRAY_W[0] + f[..., 1] * _GRAY_W[1] + f[..., 2] * _GRAY_W[2]
    return g[..., None].expand(f.shape).to(imgs.dtype)


def random_grayscale(generator: Optional[torch.Generator], imgs: torch.Tensor, p: float = 0.3,
                     *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    mask = _bernoulli(generator, p, imgs.shape[0], imgs.device) if mask is None else mask
    return torch.where(mask.to(imgs.device)[:, None, None, None], grayscale(imgs), imgs)


def random_cutout(generator: Optional[torch.Generator], imgs: torch.Tensor, min_cut: int = 10,
                  max_cut: int = 30, color: Optional[torch.Tensor] = None, *,
                  sizes: Optional[torch.Tensor] = None, h0: Optional[torch.Tensor] = None,
                  w0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A box of side ``sizes`` ∈ [min_cut, max_cut) at ``h0`` ∈ [0, H −
    max_cut), ``w0`` ∈ [0, W − max_cut) per image, filled with zeros or
    ``color`` ([B, C] or broadcastable to it). An empty range gives its
    lower end (``h0`` 0 where H ≤ max_cut), as ``jax.random.randint``
    does."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    sizes = _randint(generator, min_cut, max_cut, (B,), dev) if sizes is None else sizes.to(dev)
    h0 = _randint(generator, 0, H - max_cut, (B,), dev) if h0 is None else h0.to(dev)
    w0 = _randint(generator, 0, W - max_cut, (B,), dev) if w0 is None else w0.to(dev)
    if color is None:
        fill = imgs.new_zeros((B, C))
    else:
        fill = torch.as_tensor(color, device=dev).expand(B, C).to(imgs.dtype)
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    inside = ((rows >= h0[:, None, None]) & (rows < (h0 + sizes)[:, None, None])
              & (cols >= w0[:, None, None]) & (cols < (w0 + sizes)[:, None, None]))
    return torch.where(inside[..., None], fill[:, None, None, :], imgs)


def random_cutout_color(generator: Optional[torch.Generator], imgs: torch.Tensor,
                        min_cut: int = 10, max_cut: int = 30, *,
                        color: Optional[torch.Tensor] = None, **draws) -> torch.Tensor:
    """``random_cutout`` with a colour per image and channel from [0, 255)."""
    if color is None:
        color = _randint(generator, 0, 255, (imgs.shape[0], imgs.shape[-1]), imgs.device)
    return random_cutout(generator, imgs, min_cut, max_cut, color=color, **draws)


def random_flip(generator: Optional[torch.Generator], imgs: torch.Tensor, p: float = 0.2, *,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Horizontal flip (W, axis 2 of NHWC) with probability ``p``."""
    mask = _bernoulli(generator, p, imgs.shape[0], imgs.device) if mask is None else mask
    return torch.where(mask.to(imgs.device)[:, None, None, None], imgs.flip(2), imgs)


def random_rotation(generator: Optional[torch.Generator], imgs: torch.Tensor, p: float = 0.3,
                    *, mask: Optional[torch.Tensor] = None, rot: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """A turn by ``rot`` ∈ {1, 2, 3} quarter turns (``rot90`` over H, W) with
    probability ``p``; square images."""
    B, H, W, _ = imgs.shape
    if H != W:
        raise ValueError(f"rotation takes square images, got {H}x{W}")
    dev = imgs.device
    mask = _bernoulli(generator, p, B, dev) if mask is None else mask.to(dev)
    rot = _randint(generator, 1, 4, (B,), dev) if rot is None else rot.to(dev)
    rots = torch.stack([imgs] + [torch.rot90(imgs, k, dims=(1, 2)) for k in (1, 2, 3)])
    sel = torch.where(mask, rot, torch.zeros_like(rot))
    return rots[sel, torch.arange(B, device=dev)]


def random_convolution(generator: Optional[torch.Generator], imgs: torch.Tensor, *,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A random 3×3 colour-mixing convolution per image (SAME padding):
    ``weights`` [B, 3, 3, C, C] (HWIO) from U(−1, 1); |out| clipped to
    [0, 1]. One grouped convolution (groups = B) over the batch."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    if weights is None:
        weights = _uniform(generator, -1.0, 1.0, (B, 3, 3, C, C), dev)
    f = _to_float01(imgs).permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    k = weights.to(dev, torch.float32).permute(0, 4, 3, 1, 2).reshape(B * C, C, 3, 3)
    out = F.conv2d(f, k, padding=1, groups=B).reshape(B, C, H, W).permute(0, 2, 3, 1)
    return _from_float01(out.abs().clamp(0.0, 1.0), imgs.dtype)


def random_color_jitter(generator: Optional[torch.Generator], imgs: torch.Tensor,
                        brightness: float = 0.4, contrast: float = 0.4, *,
                        b: Optional[torch.Tensor] = None, c: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Brightness ``b`` ∈ U(1 ± brightness) and contrast ``c`` ∈ U(1 ±
    contrast) per image ([B, 1, 1, 1]) about the image's mean."""
    B, dev = imgs.shape[0], imgs.device
    if b is None:
        b = _uniform(generator, 1 - brightness, 1 + brightness, (B, 1, 1, 1), dev)
    if c is None:
        c = _uniform(generator, 1 - contrast, 1 + contrast, (B, 1, 1, 1), dev)
    f = _to_float01(imgs)
    mean = f.mean(dim=(1, 2, 3), keepdim=True)
    out = ((f * b.to(dev) - mean) * c.to(dev) + mean).clamp(0.0, 1.0)
    return _from_float01(out, imgs.dtype)


def no_aug(generator: Optional[torch.Generator], imgs: torch.Tensor) -> torch.Tensor:
    return imgs


AUGMENTATIONS = {
    "crop": random_crop,
    "translate": random_translate,
    "grayscale": random_grayscale,
    "cutout": random_cutout,
    "cutout_color": random_cutout_color,
    "flip": random_flip,
    "rotation": random_rotation,
    "convolution": random_convolution,
    "color_jitter": random_color_jitter,
    "no_aug": no_aug,
}
