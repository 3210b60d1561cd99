"""StyleGAN2's generator (``G_main``, config-f's skip architecture) written from its layer
equations in plain PyTorch.

Sources: Karras, Laine, Aittala, Hellsten, Lehtinen, Aila, "Analyzing and
Improving the Image Quality of StyleGAN", CVPR 2020 (arXiv:1912.04958),
and NVlabs/stylegan2 ``training/networks_stylegan2.py`` (``G_main``,
``G_mapping``, ``G_synthesis_stylegan2``, ``get_weight``, ``dense_layer``,
``apply_bias_act``, ``modulated_conv2d_layer``) with
``dnnlib/tflib/ops/upfirdn_2d.py`` (``upfirdn_2d`` as ``_upfirdn_2d_ref``,
``upsample_2d``, ``upsample_conv_2d``). Options are the official keyword
arguments (``G``, a configuration's ``"G"`` group).

- Mapping: ``pixel_norm(z)`` (ε 1e-8), then ``mapping_layers`` dense
  layers, each ``lrelu(x·W·c + b·lrmul, 0.2)·√2`` with the equalized
  learning rate's c = 1/sqrt(fan_in)·lrmul (gain 1; the √2 is the
  activation's, ``apply_bias_act``).
- Truncation: ``lerp(dlatent_avg, w, ψ)`` on every dlatent below
  ``truncation_cutoff`` (all of them when it is None, ``G_main``'s default).
- Synthesis (``architecture='skip'``): the 4×4 ``Const``; per resolution
  the layers ``Conv`` (4²) or ``Conv0_up`` and ``Conv1``, each a modulated
  3×3 conv followed by ``x + noise·noise_strength`` and ``lrelu(x + b,
  0.2)·√2``; then ``y = upsample_2d(y) + ToRGB(x)``, toRGB a modulated 1×1
  conv without demodulation plus its bias. dlatent indices: ``Conv`` 0,
  ``Conv0_up`` 2r − 5, ``Conv1`` 2r − 4, ``ToRGB`` 2r − 3 at resolution 2^r
  (the 4² ToRGB: 1). Feature maps ``nf(s) = min(fmap_base / 2^(s·fmap_decay),
  fmap_max)``.
- The modulated conv in its fused form (``fused_modconv=True``, the
  official inference's): the style ``s = x_w·A·c + mod_bias + 1``, the
  per-image weight ``w·s`` ``[B, O, I, k, k]``, demodulated by ``rsqrt(Σ
  (w·s)² + 1e-8)`` over (I, k, k), run as ONE grouped conv over the batch
  folded into the channels (groups = B). Up-convs (``upsample_conv_2d``):
  the grouped stride-2 transposed conv with the kernel flipped (output 2H +
  1), then ``upfirdn_2d`` with the [1, 3, 3, 1] FIR × 4 and pads 1/1.
- ``upfirdn_2d``: zero insertion (``up`` − 1 zeros after each value),
  zero padding (pad0 before, pad1 after), then a depthwise 2-D convolution
  with the FIR (the kernel flipped, as ``_upfirdn_2d_ref`` does).
  ``upsample_2d``: up 2, pads 2/1.

Weights are a dict in the official variable names (``G_mapping/Dense0/
weight``, ``G_synthesis/8x8/Conv0_up/mod_weight``, ``…/noise_strength`` (a
scalar), ``G_synthesis/4x4/ToRGB/bias``, ``dlatent_avg``), held as the
variables hold them (before the run-time scale) but in PyTorch's layouts:
dense ``[out, in]``, conv ``[out, in, kh, kw]``. Every dense layer and
convolution goes through ``prec`` (``precision.Precision``), so one forward
serves the float32 reference and its lower-precision control.

Departures from the official code, each for a reason:
- Inference only.
- Noise comes in as a list of maps ``[B, 1, r, r]`` (``noise_maps``: float32
  standard normal from a ``torch.Generator``, layer order), so that the
  program and the reference use the same draw; the official
  ``randomize_noise=True`` draws them inside the graph.
- TF's ``conv2d_transpose`` is PyTorch's ``conv_transpose2d`` with the
  weight as ``[in, out, kh, kw]``; the grouped form keeps each image's
  group of channels together, as the official reshape does.
- ``demodulate=False`` drops the demodulation of every conv,
  ``use_noise=False`` every noise term, ``psi`` overrides ψ, ``fir_on=False``
  puts nearest upsampling in place of the FIR (the up-convs become a
  nearest ×2 and a 3×3 conv, the RGB upsample a nearest ×2): controls.
- Frames come out NHWC ``[B, R, R, C]``, not NCHW.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.stylegan import GAIN, coef, log2_res, nf, pixel_norm

Weights = Dict[str, torch.Tensor]
DEMOD_EPS = 1e-8
UP = 2


def num_layers(G) -> int:
    """The dlatents a pass reads: two a resolution."""
    return 2 * log2_res(G) - 2


def layers(G) -> List[Tuple[str, str, int, int, int, int]]:
    """(scope, kind, res, c_in, c_out, dlatent) of each modulated layer in
    the order a pass runs them; kind one of conv, up, rgb; the conv layers'
    order is their noise maps' order."""
    s = "G_synthesis"
    out = [(f"{s}/4x4/Conv", "conv", 4, nf(G, 1), nf(G, 1), 0),
           (f"{s}/4x4/ToRGB", "rgb", 4, nf(G, 1), G["num_channels"], 1)]
    for res in range(3, log2_res(G) + 1):
        r = 2 ** res
        out += [(f"{s}/{r}x{r}/Conv0_up", "up", r, nf(G, res - 2), nf(G, res - 1), 2 * res - 5),
                (f"{s}/{r}x{r}/Conv1", "conv", r, nf(G, res - 1), nf(G, res - 1), 2 * res - 4),
                (f"{s}/{r}x{r}/ToRGB", "rgb", r, nf(G, res - 1), G["num_channels"],
                 2 * res - 3)]
    return out


def conv_layers(G) -> List[Tuple[str, str, int, int, int, int]]:
    return [spec for spec in layers(G) if spec[1] != "rgb"]


def param_spec(G) -> Dict[str, Tuple[tuple, str]]:
    """Every variable, name → (shape, kind), kind one of mapping_weight,
    mapping_bias, const, weight, mod_weight, mod_bias, noise, bias."""
    spec: Dict[str, Tuple[tuple, str]] = {}
    L, D = G["mapping_layers"], G["dlatent_size"]
    for i in range(L):
        c_in = G["latent_size"] if i == 0 else G["mapping_fmaps"]
        c_out = D if i == L - 1 else G["mapping_fmaps"]
        spec[f"G_mapping/Dense{i}/weight"] = ((c_out, c_in), "mapping_weight")
        spec[f"G_mapping/Dense{i}/bias"] = ((c_out,), "mapping_bias")
    spec["G_synthesis/4x4/Const/const"] = ((1, nf(G, 1), 4, 4), "const")
    for scope, kind, _, c_in, c_out, _ in layers(G):
        k = 1 if kind == "rgb" else 3
        spec[f"{scope}/weight"] = ((c_out, c_in, k, k), "weight")
        spec[f"{scope}/mod_weight"] = ((c_in, D), "mod_weight")
        spec[f"{scope}/mod_bias"] = ((c_in,), "mod_bias")
        if kind != "rgb":
            spec[f"{scope}/noise_strength"] = ((), "noise")
        spec[f"{scope}/bias"] = ((c_out,), "bias")
    return spec


def noise_maps(batch: int, G, generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
    """One pass's noise maps ``[B, 1, r, r]`` (float32 standard normal), one
    a conv layer in layer order, from ``generator``."""
    return [torch.randn(batch, 1, res, res, generator=generator, device=device)
            for _, _, res, _, _, _ in conv_layers(G)]


def fir(taps: Sequence[int], gain: float, dtype, device) -> torch.Tensor:
    """``_setup_kernel(k)·gain``: the outer product of ``taps`` normalised to sum 1."""
    k = torch.tensor(taps, dtype=torch.float64)
    k = torch.outer(k, k)
    return (k / k.sum() * gain).to(dtype).to(device)


def upfirdn2d(x: torch.Tensor, k: torch.Tensor, up: int, pad0: int, pad1: int,
              prec) -> torch.Tensor:
    """``_upfirdn_2d_ref`` (no downsampling) on NCHW x: ``up`` − 1 zeros
    inserted after each value along H and W, ``pad0``/``pad1`` zeros before/
    after, then the depthwise convolution with the kernel ``k`` ``[kh, kw]``
    (flipped, as a convolution)."""
    B, C, H, W = x.shape
    if up > 1:
        z = x.new_zeros(B, C, H * up, W * up)
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    w = k.flip(0, 1).to(x.dtype).expand(C, 1, *k.shape).contiguous()
    return F.conv2d(prec.operand(x), prec.operand(w), groups=C)


def upsample_2d(y: torch.Tensor, G, prec, fir_on: bool = True) -> torch.Tensor:
    """``upsample_2d``: the FIR × 4 after zero insertion, pads 2/1 (p = k − 2)."""
    if not fir_on:
        return F.interpolate(y, scale_factor=UP, mode="nearest")
    k = fir(G["resample_kernel"], UP * UP, y.dtype, y.device)
    p = k.shape[0] - UP
    return upfirdn2d(y, k, UP, (p + 1) // 2 + UP - 1, p // 2, prec)


def styles(W: Weights, scope: str, dlatent: torch.Tensor, prec) -> torch.Tensor:
    """``s = dense(dlatent) + mod_bias + 1`` ``[B, I]`` (dense at gain 1)."""
    a = W[f"{scope}/mod_weight"]
    return prec.linear(dlatent, a * coef(a, 1.0), W[f"{scope}/mod_bias"]) + 1


def modulated_conv(W: Weights, G, scope: str, x: torch.Tensor, dlatent: torch.Tensor, prec,
                   up: bool = False, demodulate: bool = True,
                   fir_on: bool = True) -> torch.Tensor:
    """``modulated_conv2d_layer`` with ``fused_modconv=True``: x ``[B, I, H,
    W]`` → ``[B, O, H', W']`` (H' = 2H for an up-conv)."""
    w = W[f"{scope}/weight"]
    w = w * coef(w, 1.0)  # [O, I, k, k], gain 1
    s = styles(W, scope, dlatent, prec)
    ww = w[None] * s[:, None, :, None, None]  # [B, O, I, k, k]
    if demodulate:
        ww = ww * torch.rsqrt(ww.square().sum((2, 3, 4)) + DEMOD_EPS)[:, :, None, None, None]
    B, O, I, k, _ = ww.shape
    xg = x.reshape(1, B * I, *x.shape[2:])
    if not up:
        out = F.conv2d(prec.operand(xg), prec.operand(ww.reshape(B * O, I, k, k)),
                       padding=k // 2, groups=B)
    elif not fir_on:
        out = F.conv2d(prec.operand(F.interpolate(xg, scale_factor=UP, mode="nearest")),
                       prec.operand(ww.reshape(B * O, I, k, k)), padding=k // 2, groups=B)
    else:
        wt = ww.flip(3, 4).transpose(1, 2).reshape(B * I, O, k, k)  # [in, out] per group
        out = F.conv_transpose2d(prec.operand(xg), prec.operand(wt), stride=UP, groups=B)
        kf = fir(G["resample_kernel"], UP * UP, out.dtype, out.device)
        p = (kf.shape[0] - UP) - (k - 1)
        out = upfirdn2d(out, kf, 1, (p + 1) // 2 + UP - 1, p // 2 + 1, prec)
    return out.reshape(B, O, *out.shape[2:])


def mapping(W: Weights, G, z: torch.Tensor, prec) -> torch.Tensor:
    """``G_mapping``: z ``[B, latent_size]`` → w ``[B, dlatent_size]``."""
    x, lrmul = pixel_norm(z), G["mapping_lrmul"]
    for i in range(G["mapping_layers"]):
        w = W[f"G_mapping/Dense{i}/weight"]
        x = prec.linear(x, w * coef(w, 1.0, lrmul), W[f"G_mapping/Dense{i}/bias"] * lrmul)
        x = F.leaky_relu(x, 0.2) * GAIN
    return x


def truncate(W: Weights, G, w: torch.Tensor, psi: Optional[float] = None) -> torch.Tensor:
    """``G_main``'s truncation: per dlatent ``lerp(dlatent_avg, w, ψ_i)``,
    ``[B, num_layers, dlatent_size]``."""
    psi = G["truncation_psi"] if psi is None else psi
    cutoff = G["truncation_cutoff"]
    coefs = torch.tensor([psi if cutoff is None or i < cutoff else 1.0
                          for i in range(num_layers(G))], dtype=w.dtype, device=w.device)
    avg = W["dlatent_avg"].to(w.dtype)
    return avg + (w[:, None] - avg) * coefs[None, :, None]


def synthesis(W: Weights, G, dlatents: torch.Tensor, noise: List[torch.Tensor], prec,
              demodulate: bool = True, use_noise: bool = True,
              fir_on: bool = True) -> torch.Tensor:
    """``G_synthesis_stylegan2`` (skip): dlatents ``[B, num_layers, D]`` and
    the noise maps → frames ``[B, R, R, num_channels]``."""
    B = dlatents.shape[0]
    x, y, n = W["G_synthesis/4x4/Const/const"].expand(B, -1, -1, -1), None, 0
    for scope, kind, _, _, _, i in layers(G):
        if kind == "rgb":
            t = modulated_conv(W, G, scope, x, dlatents[:, i], prec, demodulate=False)
            t = t + W[f"{scope}/bias"].view(1, -1, 1, 1)
            y = t if y is None else upsample_2d(y, G, prec, fir_on) + t
            continue
        x = modulated_conv(W, G, scope, x, dlatents[:, i], prec, up=kind == "up",
                           demodulate=demodulate, fir_on=fir_on)
        if use_noise:
            x = x + noise[n].to(x.dtype) * W[f"{scope}/noise_strength"]
        n += 1
        x = F.leaky_relu(x + W[f"{scope}/bias"].view(1, -1, 1, 1), 0.2) * GAIN
    return y.permute(0, 2, 3, 1)


def generator(W: Weights, G, z: torch.Tensor, noise: List[torch.Tensor], prec,
              psi: Optional[float] = None, demodulate: bool = True, use_noise: bool = True,
              fir_on: bool = True) -> torch.Tensor:
    """``G_main`` at inference: latents ``[B, latent_size]`` and the noise
    maps → frames ``[B, R, R, num_channels]``."""
    dl = truncate(W, G, mapping(W, G, z, prec), psi)
    return synthesis(W, G, dl, noise, prec, demodulate, use_noise, fir_on)


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
