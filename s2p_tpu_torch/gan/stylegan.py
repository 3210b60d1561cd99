"""StyleGAN's generator in PyTorch: latents z → frames, FFHQ 1024² by default.

The style-based generator of Karras, Laine and Aila (CVPR 2019,
arXiv:1812.04948) as NVlabs/stylegan builds it in
``training/networks_stylegan.py``: ``G_style`` runs ``G_mapping`` (pixel
norm of z, then 8 dense layers of 512 with equalized learning rate at lrmul
0.01 and leaky ReLU 0.2), the truncation trick toward ``dlatent_avg`` (ψ on
the first ``truncation_cutoff`` layers) and ``G_synthesis``: a learned
4×4×512 constant, then 18 layers from 4² to 1024², each a convolution
followed by the layer epilogue noise → bias → leaky ReLU → instance norm
(ε 1e-8) → style modulation, and a 1×1 toRGB at the last resolution. Each
resolution above 4² upsamples in its first layer (``Conv0_up``): a nearest
×2 and a 3×3 conv below 128², the fused 4×4 stride-2 transposed conv of
``upscale2d_conv2d`` from 128² up (``fused_scale='auto'``), each followed by
the [1, 2, 1] blur. Feature maps: ``nf(s) = min(fmap_base / 2^s,
fmap_max)``, 512 at 4²–32², then 256, 128, 64, 32 and 16 at 1024².

Each layer's instance norm and style modulation (AdaIN) is ONE call of the
MAT-norm kernel (``cuda_kernels.fused_mat_norm``, ``adain_nchw``): its
``instance_norm(x)·(1 + γ) + β`` with γ and β one value per image and
channel, handed to it as views of pixel stride 0 (no map is materialised);
``fused_mat_norm.style_launches`` counts those launches. On the CPU the
kernel's plain version runs.

Parameters are named after the official variables, '/' read as '.'
(``G_mapping.Dense{i}.weight``, ``G_synthesis.{r}x{r}.Conv0_up.weight``,
``….Noise.weight``, ``….StyleMod.weight``, ``G_synthesis.4x4.Const.const``,
``G_synthesis.ToRGB_lod0.weight``, ``dlatent_avg``), in PyTorch's layouts:
a TF checkpoint's dense kernel ``[in, out]`` loads transposed, a conv
kernel ``[kh, kw, in, out]`` permuted to ``[out, in, kh, kw]``. Each weight
is held as the official variable holds it (equalized learning rate: drawn
at std 1/lrmul) and scaled at run time by ``runtime_coef`` (he_std ·
lrmul), a mapping bias by lrmul. Noise is drawn fresh every pass
(``randomize_noise=True``, the network's default; the stored ``noise{i}``
variables are not ported), from a ``torch.Generator`` when given, in layer
order (``noise_map``), so that another implementation can draw the same
maps. The options the port runs are the network's defaults (styles, const
input, noise, instance norm, leaky ReLU, use_wscale, fixed structure at lod
0); the fast path is ``fast_inference.synthesize_style_fast``.

Spans: ``s2p.gen.forward`` (a pass), ``s2p.style.mapping`` (mapping and
truncation), ``s2p.gen.block_<i>`` (resolution i, 0 = 4²), inside it
``s2p.gen.upsample`` (the up-conv and blur), ``s2p.style.noise`` (the noise
draw, bias and leaky ReLU) and ``s2p.style.adain`` (the kernel), and
``s2p.gen.head`` (toRGB).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.gan.cuda_kernels import fused_mat_norm, style_epilogue
from s2p_tpu_torch.utils.profiling import annotate

CL = torch.channels_last
GAIN = math.sqrt(2.0)  # the He gain of the leaky ReLU ('lrelu' in the official table)
LRELU = 0.2
NORM_EPS = 1e-8  # instance_norm's and pixel_norm's epsilon
FUSED_MIN_RES = 128  # fused_scale='auto', the official default: fused into 128² and up


def runtime_coef(shape: Sequence[int], gain: float, lrmul: float = 1.0) -> float:
    """``get_weight``'s run-time factor with ``use_wscale``: he_std · lrmul,
    he_std = gain / sqrt(fan_in), for a weight of PyTorch layout ``[out,
    in(, kh, kw)]``."""
    return gain / math.sqrt(math.prod(shape[1:])) * lrmul


def layer_res(layer: int) -> int:
    """The resolution of synthesis layer ``layer``: 4, 4, 8, 8, 16, …"""
    return 2 ** (layer // 2 + 2)


def noise_map(batch: int, layer: int, generator: Optional[torch.Generator] = None,
              device=None) -> torch.Tensor:
    """Layer ``layer``'s noise ``[B, 1, r, r]``, float32 standard normal,
    drawn from ``generator`` (its device's default generator when None)."""
    r = layer_res(layer)
    return torch.randn(batch, 1, r, r, generator=generator, device=device)


def fused_up_kernel(weight: torch.Tensor) -> torch.Tensor:
    """``upscale2d_conv2d``'s fused kernel: the scaled 3×3 weight ``[out, in,
    3, 3]`` zero-padded to 5×5 and summed over its four 4×4 windows, as the
    ``conv_transpose2d`` weight ``[in, out, 4, 4]`` (stride 2, padding 1).
    That op is a nearest ×2 followed by a 3×3 conv with the kernel flipped
    in both spatial axes, so ``fused_up_kernel(w.flip(2, 3))`` runs the
    nearest path's ``conv(upscale(x), w)`` as one transposed conv."""
    w = F.pad(weight, (1, 1, 1, 1))
    w = w[:, :, 1:, 1:] + w[:, :, :-1, 1:] + w[:, :, 1:, :-1] + w[:, :, :-1, :-1]
    return w.transpose(0, 1)


def blur_kernel(channels: int, taps: Sequence[int], dtype=torch.float32,
                device=None) -> torch.Tensor:
    """``_blur2d``'s depthwise filter ``[C, 1, k, k]``: the outer product of
    ``taps`` with itself, normalised to sum 1."""
    f = torch.tensor(taps, dtype=torch.float64)
    f = torch.outer(f, f)
    f = (f / f.sum()).to(dtype)
    return f.expand(channels, 1, *f.shape).contiguous().to(device)


def adain_nchw(x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """``style_mod(instance_norm(x))``: x NCHW (channels_last memory), style
    ``[B, 2C]`` (γ's C values, then β's, unit channel stride), through the
    MAT-norm kernel's NHWC views with γ and β broadcast over the pixels at
    stride 0; ε 1e-8. Returns NCHW in channels_last memory."""
    B, C, H, W = x.shape
    g = style[:, :C].view(B, 1, 1, C).expand(B, H, W, C)
    b = style[:, C:].view(B, 1, 1, C).expand(B, H, W, C)
    with annotate("s2p.style.adain"):
        out = fused_mat_norm(x.contiguous(memory_format=CL).permute(0, 2, 3, 1), g, b,
                             eps=NORM_EPS)
    return out.permute(0, 3, 1, 2)


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + NORM_EPS)


class Noise(nn.Module):
    """A layer's per-channel noise strength (``Noise/weight``, init 0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))


class StyleMod(nn.Module):
    """A layer's style affine (``StyleMod``): dlatent → γ‖β ``[B, 2C]``,
    dense with gain 1 and a bias."""

    def __init__(self, channels: int, dlatent_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(2 * channels, dlatent_size))
        self.bias = nn.Parameter(torch.zeros(2 * channels))

    def forward(self, dlatent: torch.Tensor) -> torch.Tensor:
        return F.linear(dlatent, self.weight * runtime_coef(self.weight.shape, 1.0), self.bias)


class Dense(nn.Module):
    """A mapping layer (``G_mapping/Dense{i}``): equalized-lr dense with lrmul."""

    def __init__(self, c_in: int, c_out: int, lrmul: float):
        super().__init__()
        self.lrmul = lrmul
        self.weight = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * runtime_coef(self.weight.shape, GAIN, self.lrmul)
        return F.leaky_relu(F.linear(x, w, self.bias * self.lrmul), LRELU)


class SynthesisLayer(nn.Module):
    """One of the synthesis layers: its conv weight (``kind`` "conv" or
    "up", ``[out, in, 3, 3]``) or the 4×4 constant (``kind`` "const"), and
    its epilogue's noise strength, bias and style affine."""

    def __init__(self, kind: str, c_in: int, c_out: int, dlatent_size: int):
        super().__init__()
        self.kind = kind
        if kind == "const":
            self.const = nn.Parameter(torch.ones(1, c_out, 4, 4))
        else:
            self.weight = nn.Parameter(torch.empty(c_out, c_in, 3, 3))
        self.Noise = Noise(c_out)
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.StyleMod = StyleMod(c_out, dlatent_size)

    def conv_weight(self) -> torch.Tensor:
        return self.weight * runtime_coef(self.weight.shape, GAIN)


class ToRGB(nn.Module):
    """``ToRGB_lod0``: a 1×1 conv (gain 1) with a bias."""

    def __init__(self, c_in: int, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, c_in, 1, 1))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * runtime_coef(self.weight.shape, 1.0), self.bias)


class StyleGANGenerator(nn.Module):
    """``G_style`` (NVlabs/stylegan ``networks_stylegan.py``), at inference.

    The options are the official ones (``resolution``, ``latent_size``,
    ``dlatent_size``, ``mapping_layers``, ``mapping_fmaps``,
    ``mapping_lrmul``, ``num_channels``, ``fmap_base``, ``fmap_decay``,
    ``fmap_max``, ``truncation_psi``, ``truncation_cutoff``,
    ``blur_filter``; ``fused_scale`` is the official default 'auto',
    ``FUSED_MIN_RES``). ``forward(z, noise_gen)`` takes latents ``[B,
    latent_size]`` and returns frames ``[B, R, R, num_channels]`` (NHWC; no
    tanh: StyleGAN's images are unbounded), under ``torch.no_grad()``: the
    epilogue kernel has no backward. The parameters start at the official
    init (weights N(0, 1/lrmul), biases and noise strengths 0, the constant
    1), drawn on ``device`` from its default generator, for
    ``load_state_dict`` to replace; conv weights are in channels_last
    memory. ``dlatent_avg``
    stays float32 whatever type the module is cast to, as a bf16
    deployment keeps such a statistic."""

    def __init__(self, resolution: int = 1024, latent_size: int = 512,
                 dlatent_size: int = 512, mapping_layers: int = 8, mapping_fmaps: int = 512,
                 mapping_lrmul: float = 0.01, num_channels: int = 3, fmap_base: int = 8192,
                 fmap_decay: float = 1.0, fmap_max: int = 512, truncation_psi: float = 0.7,
                 truncation_cutoff: int = 8, blur_filter: Sequence[int] = (1, 2, 1),
                 device: str | torch.device = "cuda"):
        super().__init__()
        log2 = int(round(math.log2(resolution)))
        if resolution != 2 ** log2 or resolution < 8:
            raise ValueError(f"resolution {resolution}: a power of two, at least 8")
        self.resolution, self.latent_size, self.dlatent_size = resolution, latent_size, dlatent_size
        self.fmap_base, self.fmap_decay, self.fmap_max = fmap_base, fmap_decay, fmap_max
        self.truncation_psi, self.truncation_cutoff = truncation_psi, truncation_cutoff
        self.blur_filter = tuple(blur_filter)

        with torch.device(device):  # built and drawn on the device
            mapping = nn.Module()
            for i in range(mapping_layers):
                c_in = latent_size if i == 0 else mapping_fmaps
                c_out = dlatent_size if i == mapping_layers - 1 else mapping_fmaps
                mapping.add_module(f"Dense{i}", Dense(c_in, c_out, mapping_lrmul))
            self.G_mapping = mapping
            synthesis = nn.Module()
            for res in range(2, log2 + 1):
                synthesis.add_module(f"{2 ** res}x{2 ** res}", nn.Module())
            for scope, name, kind, c_in, c_out in self.layer_specs:
                synthesis.get_submodule(scope).add_module(
                    name, SynthesisLayer(kind, c_in, c_out, dlatent_size))
            synthesis.add_module("ToRGB_lod0", ToRGB(self.nf(log2 - 1), num_channels))
            self.G_synthesis = synthesis
            self.register_buffer("dlatent_avg", torch.zeros(dlatent_size))
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".weight") and p.dim() > 1:  # N(0, 1/lrmul), as use_wscale draws
                    p.normal_(0.0, 1.0 / (mapping_lrmul if name.startswith("G_mapping.") else 1.0))
        self.to(memory_format=CL)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._buffers["dlatent_avg"] = self._buffers["dlatent_avg"].float()
        return self

    def nf(self, stage: int) -> int:
        return min(int(self.fmap_base / (2.0 ** (stage * self.fmap_decay))), self.fmap_max)

    @property
    def num_layers(self) -> int:
        return 2 * int(round(math.log2(self.resolution))) - 2

    @property
    def layer_specs(self) -> List[Tuple[str, str, str, int, int]]:
        """(scope, name, kind, c_in, c_out) of each synthesis layer, in order:
        ``4x4/Const``, ``4x4/Conv``, then ``{r}x{r}/Conv0_up`` and
        ``{r}x{r}/Conv1`` per resolution."""
        out = [("4x4", "Const", "const", 0, self.nf(1)), ("4x4", "Conv", "conv", self.nf(1),
                                                          self.nf(1))]
        for res in range(3, int(round(math.log2(self.resolution))) + 1):
            scope = f"{2 ** res}x{2 ** res}"
            out += [(scope, "Conv0_up", "up", self.nf(res - 2), self.nf(res - 1)),
                    (scope, "Conv1", "conv", self.nf(res - 1), self.nf(res - 1))]
        return out

    def layers(self) -> List[SynthesisLayer]:
        return [self.G_synthesis.get_submodule(f"{s}.{n}") for s, n, *_ in self.layer_specs]

    @staticmethod
    def fused(res: int) -> bool:
        """Whether the up-conv into ``res`` is the fused transposed conv."""
        return res >= FUSED_MIN_RES

    def psi(self, layer: int) -> float:
        """The truncation coefficient of synthesis layer ``layer``."""
        return self.truncation_psi if layer < self.truncation_cutoff else 1.0

    def mapping(self, z: torch.Tensor) -> torch.Tensor:
        """``G_mapping``: z ``[B, latent_size]`` → w ``[B, dlatent_size]``."""
        x = pixel_norm(z)
        for dense in self.G_mapping.children():
            x = dense(x)
        return x

    def truncate(self, w: torch.Tensor) -> torch.Tensor:
        """``G_style``'s truncation: ``lerp(dlatent_avg, w, ψ_i)`` per layer,
        ``[B, num_layers, dlatent_size]``."""
        coefs = torch.tensor([self.psi(i) for i in range(self.num_layers)], dtype=w.dtype,
                             device=w.device)
        avg = self.dlatent_avg.to(w.dtype)
        return avg + (w[:, None] - avg) * coefs[None, :, None]

    @torch.no_grad()
    def forward(self, z: torch.Tensor, noise_gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Latents ``[B, latent_size]`` → frames ``[B, R, R, num_channels]``;
        each layer's noise is drawn from ``noise_gen`` in layer order."""
        B = z.shape[0]
        with annotate("s2p.gen.forward"):
            with annotate("s2p.style.mapping"):
                dl = self.truncate(self.mapping(z))
            x, layers = None, self.layers()
            for block in range(self.num_layers // 2):  # two layers a resolution
                with annotate(f"s2p.gen.block_{block}"):
                    for i in (2 * block, 2 * block + 1):
                        x = self._layer(i, layers[i], x, dl[:, i], noise_gen, B)
            with annotate("s2p.gen.head"):
                x = self.G_synthesis.ToRGB_lod0(x)
            return x.permute(0, 2, 3, 1)

    def _layer(self, i: int, layer: SynthesisLayer, x, dlatent, noise_gen, B: int):
        if layer.kind == "const":  # a copy: the epilogue writes it in place
            x = layer.const.expand(B, -1, -1, -1).clone(memory_format=CL)
        elif layer.kind == "conv":
            x = F.conv2d(x, layer.conv_weight(), padding=1)
        else:
            res = 2 * x.shape[-1]
            with annotate("s2p.gen.upsample"):
                if self.fused(res):
                    x = F.conv_transpose2d(x, fused_up_kernel(layer.conv_weight()), stride=2,
                                           padding=1)
                else:
                    x = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"),
                                 layer.conv_weight(), padding=1)
                C = x.shape[1]
                x = F.conv2d(x, blur_kernel(C, self.blur_filter, x.dtype, x.device), padding=1,
                             groups=C)
        x = x.contiguous(memory_format=CL)
        with annotate("s2p.style.noise"):
            n = noise_map(B, i, noise_gen, x.device)
            style_epilogue(x.permute(0, 2, 3, 1), n.view(B, *n.shape[2:]), layer.Noise.weight,
                           layer.bias, LRELU)
        return adain_nchw(x, layer.StyleMod(dlatent))
