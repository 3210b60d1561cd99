"""StyleGAN2's generator in PyTorch: latents z → frames, config-f at FFHQ 1024² by default.

The generator of Karras et al., "Analyzing and Improving the Image Quality
of StyleGAN" (CVPR 2020, arXiv:1912.04958), as NVlabs/stylegan2 builds it
in ``training/networks_stylegan2.py``: ``G_main`` runs ``G_mapping``
(StyleGAN's, ``stylegan.StyleBase``, but with the He gain √2 after each
layer's bias and leaky ReLU, ``apply_bias_act``), the truncation toward
``dlatent_avg`` (ψ on every dlatent: ``truncation_cutoff=None``) and
``G_synthesis_stylegan2`` with the skip architecture: a learned 4×4
constant, then per resolution the modulated convs and a toRGB whose RGB
image is summed over the resolutions, each earlier sum upsampled.

- A modulated conv (``modulated_conv2d_layer``): the style ``s = A(w) +
  mod_bias + 1`` (``A`` dense at gain 1) scales the weight per image and
  input channel, and the demodulation ``d[b, o] = rsqrt(Σ_{i,k} (w[o, i,
  k]·s[b, i])² + 1e-8)`` per image and output channel. The official
  inference runs the scaled weights as a grouped conv (``fused_modconv``);
  this module runs the equivalent ``fused_modconv=False`` form: x·s, the
  shared-weight conv, then ·d.
- A layer: the modulated 3×3 conv, then ``x + noise·noise_strength`` (one
  scalar strength) and ``lrelu(x + bias, 0.2)·√2``.
- ``Conv0_up`` upsamples in its conv (``upsample_conv_2d``): a 3×3
  stride-2 transposed conv with the kernel flipped, then the [1, 3, 3, 1]
  FIR (×4, pads 1/1). The skip's RGB upsample is ``upsample_2d``: the same
  FIR after zero insertion (pads 2/1).
- toRGB: a modulated 1×1 conv without demodulation, plus its bias, linear.
- Feature maps ``nf(s) = min(fmap_base / 2^s, fmap_max)``: config-f's
  ``fmap_base`` 16,384 (``G_synthesis_stylegan2``'s default, which
  ``run_training.py`` narrows only for configs a–e) keeps 512 up to 64²,
  then 256, 128, 64 and 32 at 1024².
- dlatents: the 4² ``Conv`` reads 0 and its ``ToRGB`` 1; resolution ``2^r``
  reads ``2r − 5`` (``Conv0_up``), ``2r − 4`` (``Conv1``) and ``2r − 3``
  (``ToRGB``): 18 in all. Noise: one map a conv layer, 17, in layer order.

Parameters are named after the official variables, '/' read as '.'
(``G_mapping.Dense{i}.weight``, ``G_synthesis.4x4.Const.const``,
``G_synthesis.{r}x{r}.Conv0_up.{weight,mod_weight,mod_bias,
noise_strength,bias}``, ``….Conv1.*``, ``….ToRGB.{weight,mod_weight,
mod_bias,bias}``, ``dlatent_avg``) in PyTorch's layouts (a dense kernel
``[out, in]``, a conv kernel ``[out, in, kh, kw]``), held as the variables
hold them and scaled at run time by ``runtime_coef`` (equalized learning
rate). ``noise_strength`` is a scalar, as officially. Noise is drawn fresh
each pass from ``noise_gen`` (``randomize_noise=True``; the stored
``noise{i}`` inputs are not ported) in layer order (``stylegan.noise_map``
with one layer at 4²). The fast path is
``fast_inference.synthesize_style_fast``.

Spans: ``s2p.gen.forward`` (a pass), ``s2p.style.mapping`` (mapping and
truncation), ``s2p.gen.block_<i>`` (resolution i, 0 = 4²), inside it
``s2p.style.modulate`` (each conv's style, demodulation coefficients and
input scaling), ``s2p.gen.upsample`` (the up-conv and its FIR),
``s2p.style.noise`` (the noise draw, demodulation, noise, bias and
activation) and ``s2p.style.skip`` (toRGB and the RGB upsample).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.gan.stylegan import (CL, GAIN, LRELU, StyleBase, blur_kernel, noise_map,
                                        runtime_coef)
from s2p_tpu_torch.utils.profiling import annotate

DEMOD_EPS = 1e-8
FIR = (1, 3, 3, 1)  # resample_kernel, the official default
UP = 2  # the upsampling factor; upfirdn's kernels are scaled by its square


def fir_kernel(channels: int, taps: Sequence[int] = FIR, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """``_setup_kernel(k)·factor²`` depthwise ``[C, 1, k, k]``: StyleGAN's
    normalised blur kernel times 4. ``upfirdn_2d`` convolves with it (a
    correlation with the kernel flipped)."""
    return blur_kernel(channels, taps, dtype, device, gain=UP * UP)


def fir_taps(taps: Sequence[int] = FIR) -> Tuple[float, ...]:
    """The 1-D taps whose outer product is ``fir_kernel``: ``taps`` normalised
    to sum 1, times the factor (the FIR is separable)."""
    total = float(sum(taps))
    return tuple(UP * t / total for t in taps)


def upsample_2d(x: torch.Tensor, taps: Sequence[int] = FIR) -> torch.Tensor:
    """``upsample_2d``: x ``[B, C, H, W]`` → ``[B, C, 2H, 2W]``, zero
    insertion then the FIR with pads 2/1, written as the depthwise
    transposed conv of stride 2 and padding 1 with the kernel itself."""
    C = x.shape[1]
    return F.conv_transpose2d(x, fir_kernel(C, taps, x.dtype, x.device), stride=UP, padding=1,
                              groups=C)


def up_weight(weight: torch.Tensor) -> torch.Tensor:
    """``upsample_conv_2d``'s transposed-conv weight for a run-time-scaled
    conv kernel ``[out, in, k, k]``: flipped in both spatial axes, as
    ``[in, out, k, k]``, so that the stride-2 transposed conv is zero
    insertion and the correlation with the kernel itself."""
    return weight.flip(2, 3).transpose(0, 1)


def upsample_conv_2d(x: torch.Tensor, weight: torch.Tensor,
                     taps: Sequence[int] = FIR) -> torch.Tensor:
    """``upsample_conv_2d``: x ``[B, I, H, W]`` and the run-time-scaled
    kernel ``[O, I, 3, 3]`` → ``[B, O, 2H, 2W]``: the stride-2 transposed
    conv (``up_weight``, output 2H + 1), then the FIR with pads 1/1."""
    x = F.conv_transpose2d(x, up_weight(weight), stride=UP)
    C = x.shape[1]
    return F.conv2d(x, fir_kernel(C, taps, x.dtype, x.device).flip(2, 3), padding=1, groups=C)


def demod_coef(style: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``d[b, o] = rsqrt(Σ_{i,k} (w[o, i, k]·s[b, i])² + 1e-8)`` from the
    styles ``[B, I]`` and the run-time-scaled kernel ``[O, I, k, k]``: one
    product of s² with the kernel's squares summed over its taps."""
    return torch.rsqrt(style.square() @ weight.square().sum((2, 3)).t() + DEMOD_EPS)


class ModulatedConv(nn.Module):
    """A modulated conv layer (``Conv``, ``Conv0_up``, ``Conv1``) with its
    noise and bias, or toRGB (``rgb``: 1×1, no demodulation, no noise, a
    linear bias)."""

    def __init__(self, c_in: int, c_out: int, dlatent_size: int, kernel: int = 3,
                 up: bool = False, rgb: bool = False):
        super().__init__()
        self.up, self.rgb = up, rgb
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel))
        self.mod_weight = nn.Parameter(torch.empty(c_in, dlatent_size))
        self.mod_bias = nn.Parameter(torch.zeros(c_in))
        if not rgb:
            self.noise_strength = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def style(self, dlatent: torch.Tensor) -> torch.Tensor:
        """``s = dense(w) + mod_bias + 1`` ``[B, c_in]``."""
        a = self.mod_weight * runtime_coef(self.mod_weight.shape, 1.0)
        return F.linear(dlatent, a, self.mod_bias) + 1

    def conv_weight(self) -> torch.Tensor:
        return self.weight * runtime_coef(self.weight.shape, 1.0)

    def forward(self, x: torch.Tensor, dlatent: torch.Tensor, layer: int = 0,
                noise_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """The layer on x ``[B, c_in, H, W]`` with its dlatent ``[B, D]``;
        a conv layer draws its noise map (layer ``layer``) from ``noise_gen``."""
        w = self.conv_weight()
        with annotate("s2p.style.modulate"):
            s = self.style(dlatent)
            x = x * s[:, :, None, None].to(x.dtype)
            d = None if self.rgb else demod_coef(s, w)
        if self.rgb:
            return F.conv2d(x, w, self.bias)
        if self.up:
            with annotate("s2p.gen.upsample"):
                x = upsample_conv_2d(x, w)
        else:
            x = F.conv2d(x, w, padding=w.shape[-1] // 2)
        with annotate("s2p.style.noise"):
            n = noise_map(x.shape[0], layer, noise_gen, x.device, StyleGAN2Generator.FIRST_LAYERS)
            x = x * d[:, :, None, None].to(x.dtype) + n.to(x.dtype) * self.noise_strength
            return F.leaky_relu(x + self.bias.view(1, -1, 1, 1), LRELU) * GAIN


class StyleGAN2Generator(StyleBase):
    """``G_main`` with ``G_synthesis_stylegan2`` (NVlabs/stylegan2
    ``networks_stylegan2.py``, ``architecture='skip'``), at inference.

    The options are the official ones (``resolution``, ``latent_size``,
    ``dlatent_size``, ``mapping_layers``, ``mapping_fmaps``,
    ``mapping_lrmul``, ``num_channels``, ``fmap_base``, ``fmap_decay``,
    ``fmap_max``, ``truncation_psi``, ``truncation_cutoff``,
    ``resample_kernel``); the defaults are config-f's at FFHQ 1024² served
    as ``run_generator.py`` serves it (ψ 0.5 on every dlatent).
    ``forward(z, noise_gen)`` takes latents ``[B, latent_size]`` and returns
    frames ``[B, R, R, num_channels]`` (NHWC; no tanh), in plain PyTorch
    (differentiable). The parameters start at the official init (weights
    N(0, 1/lrmul), biases, mod biases and noise strengths 0, the constant
    N(0, 1)), drawn on ``device`` from its default generator, for
    ``load_state_dict`` to replace; conv weights are in channels_last
    memory (``StyleBase`` keeps ``dlatent_avg`` float32)."""

    FIRST_LAYERS = 1  # conv layers at 4²: the noise maps' resolutions follow

    def __init__(self, resolution: int = 1024, latent_size: int = 512,
                 dlatent_size: int = 512, mapping_layers: int = 8, mapping_fmaps: int = 512,
                 mapping_lrmul: float = 0.01, num_channels: int = 3, fmap_base: int = 16384,
                 fmap_decay: float = 1.0, fmap_max: int = 512, truncation_psi: float = 0.5,
                 truncation_cutoff: Optional[int] = None,
                 resample_kernel: Sequence[int] = FIR, device: str | torch.device = "cuda"):
        super().__init__(resolution, latent_size, dlatent_size, mapping_layers, mapping_fmaps,
                         mapping_lrmul, fmap_base, fmap_decay, fmap_max, truncation_psi,
                         truncation_cutoff)
        self.resample_kernel = tuple(resample_kernel)
        with torch.device(device):  # built and drawn on the device
            self._build_mapping(act_gain=True)
            synthesis = nn.Module()
            for res in range(2, self.log2_res + 1):
                synthesis.add_module(f"{2 ** res}x{2 ** res}", nn.Module())
            const = nn.Module()
            const.const = nn.Parameter(torch.empty(1, self.nf(1), 4, 4))
            synthesis.get_submodule("4x4").add_module("Const", const)
            for scope, name, kind, c_in, c_out in self.layer_specs:
                synthesis.get_submodule(scope).add_module(
                    name, ModulatedConv(c_in, c_out, dlatent_size, up=kind == "up"))
                if name != "Conv0_up":  # the block's toRGB follows its last conv
                    synthesis.get_submodule(scope).add_module(
                        "ToRGB", ModulatedConv(c_out, num_channels, dlatent_size, kernel=1,
                                               rgb=True))
            self.G_synthesis = synthesis
            self._finish_init()
            with torch.no_grad():
                const.const.normal_()

    @property
    def layer_specs(self) -> List[Tuple[str, str, str, int, int]]:
        """(scope, name, kind, c_in, c_out) of each modulated 3×3 conv, in
        layer order (the index of each is its dlatent's and its noise's):
        ``4x4/Conv``, then ``{r}x{r}/Conv0_up`` (kind "up") and
        ``{r}x{r}/Conv1`` per resolution."""
        out = [("4x4", "Conv", "conv", self.nf(1), self.nf(1))]
        for res in range(3, self.log2_res + 1):
            scope = f"{2 ** res}x{2 ** res}"
            out += [(scope, "Conv0_up", "up", self.nf(res - 2), self.nf(res - 1)),
                    (scope, "Conv1", "conv", self.nf(res - 1), self.nf(res - 1))]
        return out

    def layers(self) -> List[ModulatedConv]:
        return [self.G_synthesis.get_submodule(f"{s}.{n}") for s, n, *_ in self.layer_specs]

    def torgbs(self) -> List[ModulatedConv]:
        """Each resolution's toRGB, 4² first; resolution i reads dlatent 2i + 1."""
        return [self.G_synthesis.get_submodule(f"{2 ** r}x{2 ** r}.ToRGB")
                for r in range(2, self.log2_res + 1)]

    def forward(self, z: torch.Tensor, noise_gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Latents ``[B, latent_size]`` → frames ``[B, R, R, num_channels]``;
        each conv layer's noise is drawn from ``noise_gen`` in layer order."""
        B = z.shape[0]
        with annotate("s2p.gen.forward"):
            with annotate("s2p.style.mapping"):
                dl = self.truncate(self.mapping(z))
            const = self.G_synthesis.get_submodule("4x4.Const").const
            x, y, layers = const.expand(B, -1, -1, -1), None, self.layers()
            for block, rgb in enumerate(self.torgbs()):
                with annotate(f"s2p.gen.block_{block}"):
                    for i in ([0] if block == 0 else [2 * block - 1, 2 * block]):
                        x = layers[i](x, dl[:, i], i, noise_gen)
                    x = x.contiguous(memory_format=CL)
                    with annotate("s2p.style.skip"):
                        t = rgb(x, dl[:, 2 * block + 1])
                        y = t if y is None else upsample_2d(y, self.resample_kernel) + t
            return y.permute(0, 2, 3, 1)
