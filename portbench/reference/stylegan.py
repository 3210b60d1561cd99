"""StyleGAN's generator (``G_style``) written from its layer equations in plain PyTorch.

Sources: Karras, Laine, Aila, "A Style-Based Generator Architecture for
Generative Adversarial Networks", CVPR 2019 (arXiv:1812.04948), and
NVlabs/stylegan ``training/networks_stylegan.py`` (``G_style``,
``G_mapping``, ``G_synthesis`` and the layer helpers ``get_weight``,
``dense``, ``conv2d``, ``upscale2d_conv2d``, ``apply_bias``,
``apply_noise``, ``pixel_norm``, ``instance_norm``, ``style_mod``,
``blur2d``). Options are the official keyword arguments (``G``, a
configuration's ``"G"`` group).

- Mapping: ``pixel_norm(z)`` (ε 1e-8), then ``mapping_layers`` dense
  layers, each ``lrelu(x·W·c + b·lrmul, 0.2)`` with the equalized learning
  rate's c = sqrt(2)/sqrt(fan_in)·lrmul.
- Truncation: ``lerp(dlatent_avg, w, ψ)`` on layers below
  ``truncation_cutoff``, w itself above.
- Synthesis: 4×4 ``Const``, then ``Conv`` (3×3); per resolution r = 8…R a
  ``Conv0_up`` (nearest ×2 then a 3×3 conv, or from 128² the fused 4×4
  stride-2 transposed conv, ``fused_scale='auto'``) followed by the
  [1, 2, 1] blur (zero padded), then ``Conv1``; every layer ends in the
  epilogue ``x + noise·s`` → ``+ b`` → ``lrelu`` → ``instance_norm`` (float32,
  ε 1e-8) → ``x·(1 + γ) + β`` with ``γ‖β = dense(dlatent_i)`` (gain 1);
  ``ToRGB_lod0``, a 1×1 conv (gain 1) with a bias. Feature maps ``nf(s) =
  min(fmap_base / 2^(s·fmap_decay), fmap_max)``.

Weights are a dict in the official variable names (``G_mapping/Dense0/
weight``, ``G_synthesis/8x8/Conv0_up/Noise/weight``, ``dlatent_avg``), held
as the variables hold them (before the run-time scale) but in PyTorch's
layouts: dense ``[out, in]``, conv ``[out, in, kh, kw]`` (a TF checkpoint's
``[in, out]`` and ``[kh, kw, in, out]`` transposed). Every dense layer and
convolution goes through ``prec`` (``precision.Precision``), so one forward
serves the float32 reference and its lower-precision control.

Departures from the official code, each for a reason:
- Inference only, at lod 0 with the fixed structure (the trained network's
  output; ``structure='recursive'`` gives the same at lod 0).
- Noise comes in as a list of maps ``[B, 1, r, r]`` (``noise_maps``: float32
  standard normal from a ``torch.Generator``, layer order), so that the
  program and the reference use the same draw; the official
  ``randomize_noise=True`` draws them inside the graph, in the activations'
  type.
- The fused up-conv is ``F.conv_transpose2d`` with the official 4×4 kernel
  (TF's ``conv2d_transpose`` is the same adjoint of a correlation); it
  equals a nearest ×2 and a 3×3 conv with the kernel flipped in both
  spatial axes (``tests/test_torch_stylegan.py`` holds it so in f32).
- ``norm=False`` leaves the instance norm out, ``use_noise=False`` drops every
  noise strength, ``psi`` overrides ψ (controls).
- Frames come out NHWC ``[B, R, R, C]``, not NCHW.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
GAIN = math.sqrt(2.0)
EPS = 1e-8
FUSED_MIN_RES = 128  # fused_scale='auto'


def log2_res(G) -> int:
    r = int(round(math.log2(G["resolution"])))
    if 2 ** r != G["resolution"] or r < 3:
        raise ValueError(f"resolution {G['resolution']}: a power of two, at least 8")
    return r


def nf(G, stage: int) -> int:
    return min(int(G["fmap_base"] / (2.0 ** (stage * G["fmap_decay"]))), G["fmap_max"])


def num_layers(G) -> int:
    return 2 * log2_res(G) - 2


def layers(G) -> List[Tuple[str, str, int, int, int]]:
    """(scope, kind, res, c_in, c_out) of each synthesis layer, in order;
    scope is the variable scope (``G_synthesis/8x8/Conv0_up``), kind one of
    const, conv, up."""
    s = "G_synthesis"
    out = [(f"{s}/4x4/Const", "const", 4, 0, nf(G, 1)),
           (f"{s}/4x4/Conv", "conv", 4, nf(G, 1), nf(G, 1))]
    for res in range(3, log2_res(G) + 1):
        r = 2 ** res
        out += [(f"{s}/{r}x{r}/Conv0_up", "up", r, nf(G, res - 2), nf(G, res - 1)),
                (f"{s}/{r}x{r}/Conv1", "conv", r, nf(G, res - 1), nf(G, res - 1))]
    return out


def fused(res: int) -> bool:
    """``fused_scale='auto'``, the official default: the up-conv into
    ``res`` is fused where the output is at least 128²."""
    return res >= FUSED_MIN_RES


def param_spec(G) -> Dict[str, Tuple[tuple, str]]:
    """Every variable, name → (shape, kind), kind one of weight, bias,
    noise, const; the mapping's weights and biases are ``mapping`` ones."""
    spec: Dict[str, Tuple[tuple, str]] = {}
    L, D = G["mapping_layers"], G["dlatent_size"]
    for i in range(L):
        c_in = G["latent_size"] if i == 0 else G["mapping_fmaps"]
        c_out = D if i == L - 1 else G["mapping_fmaps"]
        spec[f"G_mapping/Dense{i}/weight"] = ((c_out, c_in), "mapping_weight")
        spec[f"G_mapping/Dense{i}/bias"] = ((c_out,), "mapping_bias")
    for scope, kind, _, c_in, c_out in layers(G):
        if kind == "const":
            spec[f"{scope}/const"] = ((1, c_out, 4, 4), "const")
        else:
            spec[f"{scope}/weight"] = ((c_out, c_in, 3, 3), "weight")
        spec[f"{scope}/Noise/weight"] = ((c_out,), "noise")
        spec[f"{scope}/bias"] = ((c_out,), "bias")
        spec[f"{scope}/StyleMod/weight"] = ((2 * c_out, D), "weight")
        spec[f"{scope}/StyleMod/bias"] = ((2 * c_out,), "bias")
    c_last = nf(G, log2_res(G) - 1)
    spec["G_synthesis/ToRGB_lod0/weight"] = ((G["num_channels"], c_last, 1, 1), "weight")
    spec["G_synthesis/ToRGB_lod0/bias"] = ((G["num_channels"],), "bias")
    return spec


def coef(w: torch.Tensor, gain: float, lrmul: float = 1.0) -> float:
    """``get_weight``'s run-time factor with use_wscale: gain/sqrt(fan_in)·lrmul."""
    return gain / math.sqrt(math.prod(w.shape[1:])) * lrmul


def noise_maps(batch: int, G, generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
    """One pass's noise maps ``[B, 1, r, r]`` (float32 standard normal), in
    layer order, from ``generator``."""
    return [torch.randn(batch, 1, res, res, generator=generator, device=device)
            for _, _, res, _, _ in layers(G)]


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + EPS)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """The official ``instance_norm``: float32, mean subtracted, then ×
    rsqrt(mean of squares + ε), cast back."""
    xf = x.float()
    xf = xf - xf.mean(dim=(2, 3), keepdim=True)
    xf = xf * torch.rsqrt(xf.square().mean(dim=(2, 3), keepdim=True) + EPS)
    return xf.to(x.dtype)


def blur2d(x: torch.Tensor, taps: Sequence[int], prec) -> torch.Tensor:
    """``blur2d``: a depthwise conv with the normalised outer product of
    ``taps``, zero padded ('SAME')."""
    f = torch.tensor(taps, dtype=torch.float64)
    f = torch.outer(f, f)
    f = (f / f.sum()).to(x.dtype).to(x.device)
    C = x.shape[1]
    w = f.expand(C, 1, *f.shape).contiguous()
    return F.conv2d(prec.operand(x), prec.operand(w), padding=f.shape[-1] // 2, groups=C)


def fused_up_weight(w: torch.Tensor) -> torch.Tensor:
    """``upscale2d_conv2d``'s fused kernel: [out, in, 3, 3] padded to 5×5,
    the sum of its four 4×4 windows, as a transposed-conv weight [in, out, 4, 4]."""
    w = F.pad(w, (1, 1, 1, 1))
    w = w[:, :, 1:, 1:] + w[:, :, :-1, 1:] + w[:, :, 1:, :-1] + w[:, :, :-1, :-1]
    return w.transpose(0, 1)


def upscale2d_conv2d(x: torch.Tensor, w: torch.Tensor, fuse: bool, prec) -> torch.Tensor:
    if not fuse:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return prec.conv(x, w, padding=1)
    return F.conv_transpose2d(prec.operand(x), prec.operand(fused_up_weight(w)), stride=2,
                              padding=1)


def mapping(W: Weights, G, z: torch.Tensor, prec) -> torch.Tensor:
    """``G_mapping``: z ``[B, latent_size]`` → w ``[B, dlatent_size]``."""
    x, lrmul = pixel_norm(z), G["mapping_lrmul"]
    for i in range(G["mapping_layers"]):
        w = W[f"G_mapping/Dense{i}/weight"]
        x = prec.linear(x, w * coef(w, GAIN, lrmul), W[f"G_mapping/Dense{i}/bias"] * lrmul)
        x = F.leaky_relu(x, 0.2)
    return x


def truncate(W: Weights, G, w: torch.Tensor, psi: Optional[float] = None) -> torch.Tensor:
    """``G_style``'s truncation: per layer ``lerp(dlatent_avg, w, ψ_i)``,
    ``[B, num_layers, dlatent_size]``."""
    psi = G["truncation_psi"] if psi is None else psi
    coefs = torch.tensor([psi if i < G["truncation_cutoff"] else 1.0
                          for i in range(num_layers(G))], dtype=w.dtype, device=w.device)
    avg = W["dlatent_avg"].to(w.dtype)
    return avg + (w[:, None] - avg) * coefs[None, :, None]


def synthesis(W: Weights, G, dlatents: torch.Tensor, noise: List[torch.Tensor], prec,
              norm: bool = True, use_noise: bool = True) -> torch.Tensor:
    """``G_synthesis``: dlatents ``[B, num_layers, D]`` and the noise maps
    → frames ``[B, R, R, num_channels]``."""
    B, x = dlatents.shape[0], None
    for i, (scope, kind, res, _, c_out) in enumerate(layers(G)):
        if kind == "const":
            x = W[f"{scope}/const"].expand(B, -1, -1, -1)
        else:
            w = W[f"{scope}/weight"]
            w = w * coef(w, GAIN)
            if kind == "conv":
                x = prec.conv(x, w, padding=1)
            else:
                x = blur2d(upscale2d_conv2d(x, w, fused(res), prec), G["blur_filter"], prec)
        if use_noise:
            x = x + noise[i].to(x.dtype) * W[f"{scope}/Noise/weight"].view(1, -1, 1, 1)
        x = F.leaky_relu(x + W[f"{scope}/bias"].view(1, -1, 1, 1), 0.2)
        if norm:
            x = instance_norm(x)
        a = W[f"{scope}/StyleMod/weight"]
        style = prec.linear(dlatents[:, i], a * coef(a, 1.0), W[f"{scope}/StyleMod/bias"])
        x = x * (style[:, :c_out, None, None] + 1) + style[:, c_out:, None, None]
    w = W["G_synthesis/ToRGB_lod0/weight"]
    x = prec.conv(x, w * coef(w, 1.0), W["G_synthesis/ToRGB_lod0/bias"])
    return x.permute(0, 2, 3, 1)


def generator(W: Weights, G, z: torch.Tensor, noise: List[torch.Tensor], prec,
              psi: Optional[float] = None, norm: bool = True,
              use_noise: bool = True) -> torch.Tensor:
    """``G_style`` at inference: latents ``[B, latent_size]`` and the noise
    maps → frames ``[B, R, R, num_channels]``."""
    dl = truncate(W, G, mapping(W, G, z, prec), psi)
    return synthesis(W, G, dl, noise, prec, norm, use_noise)


@torch.no_grad()
def dlatent_mean(W: Weights, G, n: int, generator: torch.Generator, device, prec,
                 chunk: int = 1024) -> torch.Tensor:
    """The mean of the mapping's output over ``n`` standard-normal latents
    drawn from ``generator`` (what training tracks as ``dlatent_avg``)."""
    total = torch.zeros(G["dlatent_size"], dtype=torch.float64, device=device)
    for lo in range(0, n, chunk):
        z = torch.randn(min(chunk, n - lo), G["latent_size"], generator=generator, device=device)
        total += mapping(W, G, z, prec).double().sum(0)
    return (total / n).float()
