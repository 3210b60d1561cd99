"""S2P generator in PyTorch: i_{t+1} = G(s_{t+1}, i_t).

The port of ``s2p_tpu/gan/generator.py``. Submodule names equal the flax
parameter tree (``img_enc.enc{i}``, ``state_fc0/1``, ``seed_fc``,
``block_{i}.norm_{0,1,s}.mlp_{shared,gamma,beta}``, ``conv_{0,1,s}``,
``conv_img``), so a state dict carried over from the JAX package
(``convert.state_dict_from_jax_params``) loads with ``strict=True``.

``forward`` keeps the JAX package's NHWC images in and out. Inside, image
tensors are NCHW in ``channels_last`` memory: convolutions take them as they
are, and ``permute(0, 2, 3, 1)`` of one is the NHWC-contiguous view that the
fused MAT-norm kernel (``cuda_kernels.fused_mat_norm``) reads at no cost.

``SPADEGenerator`` (``netG=spade``) is GauGAN, the generator S2P's blocks
descend from (NVlabs/SPADE, ``models/networks/generator.py``): the same
residual block (``MATResBlock``, whose norm is a parameter) with SPADE norms
conditioned on a semantic label map, under SPADE's own module names.

Each layer boundary is a span (``utils.profiling.annotate``, names under
``s2p.gen.``, ``s2p.mat.`` and ``s2p.spade.``) that a running profiler
records.
"""

from __future__ import annotations

import math
import re
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.gan.cuda_kernels import fused_mat_norm, spade_norm
from s2p_tpu_torch.utils.profiling import annotate

CL = torch.channels_last


def resolution_chain(size: int, n_levels: int) -> List[int]:
    """Full-res → seed-res sizes via repeated ceil(n/2).

    E.g. 100 → [100, 50, 25, 13, 7]; 64 → [64, 32, 16, 8, 4]."""
    sizes = [size]
    for _ in range(n_levels):
        sizes.append(-(-sizes[-1] // 2))
    return sizes


class PositionalEmbedding(nn.Module):
    """NeRF-style sinusoidal embedding of the state: ``x·2^k`` for k < F,
    ``[x, sin, cos]`` per state dimension."""

    def __init__(self, num_freqs: int = 6, include_input: bool = True):
        super().__init__()
        self.num_freqs, self.include_input = num_freqs, include_input

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        freqs = torch.tensor([2.0**k for k in range(self.num_freqs)],
                             dtype=x.dtype, device=x.device)
        xf = x[..., None] * freqs  # [..., S, F]
        enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)
        enc = enc.reshape(*x.shape[:-1], -1)
        if self.include_input:
            enc = torch.cat([x, enc], dim=-1)
        return enc

    @staticmethod
    def out_dim(state_dim: int, num_freqs: int, include_input: bool = True) -> int:
        return state_dim * (2 * num_freqs + (1 if include_input else 0))


def upsample_nearest(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Nearest resize of NCHW ``x`` to (out_size, out_size) with the index
    rule ``src = floor(dst·in/out)``, which the JAX package reproduces for
    the non-2× steps of the 100px chain (7→13, 13→25)."""
    return F.interpolate(x, size=(out_size, out_size), mode="nearest")


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free instance norm of NCHW ``x`` over its spatial dims
    (two-pass population variance, as ``jnp.var``)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def mat_norm_nchw(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``instance_norm(x) * (1 + gamma) + beta`` on NCHW tensors through the
    fused kernel's NHWC views (gamma and beta may be channel slices)."""
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    with annotate("s2p.mat.norm"):
        out = fused_mat_norm(nhwc(x.contiguous(memory_format=CL)), nhwc(gamma), nhwc(beta))
    return out.permute(0, 3, 1, 2)


def spade_norm_nchw(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``(x·scale + shift) * (1 + gamma) + beta`` on NCHW tensors, with f32
    per-channel ``scale``/``shift`` ``[C]`` (a batch norm's statistics,
    folded), through the SPADE-norm kernel's NHWC views."""
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    with annotate("s2p.mat.norm"):
        out = spade_norm(nhwc(x.contiguous(memory_format=CL)), nhwc(gamma), nhwc(beta),
                         scale, shift)
    return out.permute(0, 3, 1, 2)


def conv3x3(c_in: int, c_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1)


def broadcast_state(e: torch.Tensor, size: int) -> torch.Tensor:
    """``e [B, S]`` as a constant NCHW map ``[B, S, size, size]``."""
    return e[:, :, None, None].expand(-1, -1, size, size)


def cat_channels(*maps: torch.Tensor) -> torch.Tensor:
    """Concatenate NCHW maps along channels into one channels_last tensor."""
    nhwc = [m.permute(0, 2, 3, 1) for m in maps]
    return torch.cat(nhwc, dim=-1).permute(0, 3, 1, 2)


class MATNorm(nn.Module):
    """Multi-modal Affine Transform norm: instance norm of ``x`` modulated by
    spatial γ/β predicted from the condition (state map ‖ image feature, or
    one of them for the SAT ablations)."""

    def __init__(self, features: int, state_ch: int, image_ch: int, hidden: int = 128,
                 mat_mode: str = "mat"):
        super().__init__()
        cond_ch = {"mat": state_ch + image_ch, "sat_state": state_ch,
                   "sat_image": image_ch}.get(mat_mode)
        if cond_ch is None:
            raise ValueError(f"unknown mat_mode {mat_mode!r}")
        self.mat_mode = mat_mode
        self.mlp_shared = conv3x3(cond_ch, hidden)
        self.mlp_gamma = conv3x3(hidden, features)
        self.mlp_beta = conv3x3(hidden, features)

    def forward(self, x: torch.Tensor, state_map: torch.Tensor,
                image_feat: torch.Tensor) -> torch.Tensor:
        with annotate("s2p.mat.cond"):
            if self.mat_mode == "mat":
                cond = cat_channels(state_map, image_feat)
            elif self.mat_mode == "sat_state":
                cond = cat_channels(state_map)
            else:
                cond = image_feat
        with annotate("s2p.mat.hidden"):
            h = F.relu(self.mlp_shared(cond))
        with annotate("s2p.mat.gb"):
            gamma, beta = self.mlp_gamma(h), self.mlp_beta(h)
        return mat_norm_nchw(x, gamma, beta)


class MATResBlock(nn.Module):
    """SPADE-style residual block with MAT norms: norm → lrelu(0.2) →
    conv3x3 → norm → lrelu → conv3x3, plus a normed 1×1 shortcut when the
    channel count changes. ``norm`` (features → module) builds its norms,
    MAT norms by default; each norm takes ``x`` and the block's condition
    ``*cond`` (the state map and image feature of a MAT norm, the label map
    of a SPADE norm)."""

    def __init__(self, in_features: int, out_features: int, state_ch: int = 0,
                 image_ch: int = 0, mat_hidden: int = 128, mat_mode: str = "mat",
                 norm: Callable[[int], nn.Module] | None = None):
        super().__init__()
        fmid = min(in_features, out_features)
        norm = norm or (lambda c: MATNorm(c, state_ch, image_ch, mat_hidden, mat_mode))
        self.norm_0 = norm(in_features)
        self.conv_0 = conv3x3(in_features, fmid)
        self.norm_1 = norm(fmid)
        self.conv_1 = conv3x3(fmid, out_features)
        if in_features != out_features:
            self.norm_s = norm(in_features)
            self.conv_s = nn.Conv2d(in_features, out_features, 1, bias=False)

    def forward(self, x: torch.Tensor, *cond: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.norm_0(x, *cond), 0.2)
        h = self.conv_0(h)
        h = F.leaky_relu(self.norm_1(h, *cond), 0.2)
        h = self.conv_1(h)
        if hasattr(self, "conv_s"):
            s = self.conv_s(self.norm_s(x, *cond))
        else:
            s = x
        return s + h


class ImageEncoder(nn.Module):
    """Stride-2 pyramid over the previous image: one feature map per
    generator resolution, full-res first (k3 s2 p1 walks the ceil(n/2)
    chain the decoder upsamples through)."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        c_prev = in_channels
        for i, c in enumerate(channels):
            self.add_module(f"enc{i}", conv3x3(c_prev, c, stride=1 if i == 0 else 2))
            c_prev = c
        self.n_levels = len(channels)

    def forward(self, img: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        h = img
        for i in range(self.n_levels):
            h = F.leaky_relu(getattr(self, f"enc{i}")(h), 0.2)
            feats.append(h)
        return feats


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (±2σ) with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), std=std, a=-2 * std,
                                      b=2 * std, generator=gen))


def init_flax_style_(module: nn.Module, seed: int) -> None:
    """flax's default init of every parameter, in ``named_parameters``
    order, from ``torch.Generator().manual_seed(seed)`` on the CPU: LeCun
    normal kernels, zero biases."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            nn.init.zeros_(p)
        else:
            _lecun_normal_(p, p[0].numel(), gen)


class S2PGenerator(nn.Module):
    """``netG=s2p``: progressive upsampling from a state-seeded ``hw0×hw0``
    grid through MAT res-blocks to ``image_size``; tanh output in [-1, 1].

    Weights are initialised as flax initialises the JAX module (LeCun
    normal kernels, zero biases) from ``torch.Generator().manual_seed(seed)``
    on the CPU, so a seed gives the same weights on every device. The module
    is built on ``device``, the card unless the caller asks otherwise, with
    its conv weights in channels_last memory like its activations."""

    def __init__(self, state_dim: int, image_size: int = 64, ngf: int = 64,
                 state_freqs: int = 6, state_embed_dim: int = 256, n_up: int = 4,
                 mat_hidden: int = 128, mat_mode: str = "mat", out_channels: int = 3,
                 seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        self.image_size, self.ngf, self.n_up = image_size, ngf, n_up
        self.state_freqs, self.mat_mode = state_freqs, mat_mode
        blocks, enc_ch = self.block_channels, self.encoder_channels
        enc_by_level = enc_ch[::-1]  # encoder emits full-res first

        self.img_enc = ImageEncoder(out_channels, enc_ch)
        self.pos_embed = PositionalEmbedding(state_freqs)
        self.state_fc0 = nn.Linear(PositionalEmbedding.out_dim(state_dim, state_freqs),
                                   state_embed_dim)
        self.state_fc1 = nn.Linear(state_embed_dim, state_embed_dim)
        self.seed_fc = nn.Linear(state_embed_dim, self.sizes[0] ** 2 * blocks[0][0])
        for i, (c_in, c_out) in enumerate(blocks):
            self.add_module(f"block_{i}", MATResBlock(
                c_in, c_out, state_embed_dim, enc_by_level[i], mat_hidden, mat_mode))
        self.conv_img = conv3x3(blocks[-1][1], out_channels)

        init_flax_style_(self, seed)
        self.to(device=device, memory_format=CL)  # conv weights in the activations' layout

    @property
    def sizes(self) -> List[int]:
        """Decoder resolutions, seed-res first (e.g. [4, 8, 16, 32, 64])."""
        return resolution_chain(self.image_size, self.n_up)[::-1]

    @property
    def block_channels(self) -> List[Tuple[int, int]]:
        ngf = self.ngf
        ins = [8 * ngf, 8 * ngf, 4 * ngf, 2 * ngf, ngf]
        outs = [8 * ngf, 4 * ngf, 2 * ngf, ngf, ngf]
        return list(zip(ins[: self.n_up + 1], outs[: self.n_up + 1]))

    @property
    def encoder_channels(self) -> List[int]:
        ngf = self.ngf
        return [ngf, 2 * ngf, 4 * ngf, 8 * ngf, 8 * ngf][: self.n_up + 1]

    def embed_state(self, state: torch.Tensor) -> torch.Tensor:
        e = F.leaky_relu(self.state_fc0(self.pos_embed(state)), 0.2)
        return F.leaky_relu(self.state_fc1(e), 0.2)

    def seed_map(self, e: torch.Tensor) -> torch.Tensor:
        """``seed_fc(e)`` as NCHW channels_last: flax reshapes it to
        (B, H, W, C), so the NHWC view is built first."""
        hw0, c0 = self.sizes[0], self.block_channels[0][0]
        return self.seed_fc(e).reshape(-1, hw0, hw0, c0).permute(0, 3, 1, 2)

    def forward(self, state: torch.Tensor, prev_image: torch.Tensor) -> torch.Tensor:
        """state [B, S]; prev_image [B, H, W, C] in [-1, 1] → [B, H, W, C]."""
        with annotate("s2p.gen.forward"):
            sizes = self.sizes
            with annotate("s2p.gen.encode"):
                feats = self.img_enc(prev_image.permute(0, 3, 1, 2))
            enc_by_size = {f.shape[-1]: f for f in feats}
            with annotate("s2p.gen.embed"):
                e = self.embed_state(state)
                x = self.seed_map(e)
            for i, size in enumerate(sizes):
                with annotate(f"s2p.gen.block_{i}"):
                    x = getattr(self, f"block_{i}")(x, broadcast_state(e, size), enc_by_size[size])
                if i < len(sizes) - 1:
                    with annotate("s2p.gen.upsample"):
                        x = upsample_nearest(x, sizes[i + 1])
            with annotate("s2p.gen.head"):
                x = torch.tanh(self.conv_img(F.leaky_relu(x, 0.2)))
            return x.permute(0, 2, 3, 1)


# -- netG=spade: GauGAN ---------------------------------------------------------

UPSAMPLING_LAYERS = 5  # SPADE's num_upsampling_layers "normal"


def parse_norm_g(norm_g: str) -> str:
    """The param-free norm of SPADE's ``norm_G`` string ('batch' or
    'instance'): ``[spectral]spade<type>3x3`` with type ``syncbatch``,
    ``batch`` or ``instance``, as ``normalization.py::SPADE`` parses it (the
    port takes 3×3 convs only). ``spectral`` wraps the res-block convs in
    spectral norm, which a checkpoint's weights carry folded here
    (``convert.state_dict_from_spade``)."""
    m = re.fullmatch(r"(?:spectral)?spade(syncbatch|batch|instance)3x3", norm_g)
    if m is None:
        raise ValueError(f"norm_G {norm_g!r}: the port runs [spectral]spade"
                         "{syncbatch,batch,instance}3x3")
    return "instance" if m.group(1) == "instance" else "batch"


def label_onehot(ids: torch.Tensor, channels: int, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Integer label ids ``[B, H, W]`` as the one-hot map ``[B, channels, H,
    W]`` in channels_last memory, as SPADE's ``preprocess_input`` scatters
    them (``channels`` may exceed the ids' range: the rest stay 0)."""
    B, H, W = ids.shape
    out = torch.zeros(B, H, W, channels, dtype=dtype, device=ids.device)
    out.scatter_(3, ids.long().unsqueeze(3), 1)
    return out.permute(0, 3, 1, 2)


class RunningStats(nn.Module):
    """The param-free batch norm of a SPADE norm at inference: per-channel
    ``running_mean`` and ``running_var`` (SPADE's names), kept in float32
    whatever type the module is cast to, as a bf16 deployment keeps a batch
    norm's statistics. ``folded()`` gives ``x·a + b`` for ``(x − mean) /
    sqrt(var + eps)``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for k in ("running_mean", "running_var"):
            self._buffers[k] = self._buffers[k].float()
        return self

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a, b), f32 ``[C]``: a = rsqrt(var + eps), b = −mean·a."""
        a = torch.rsqrt(self.running_var.float() + self.eps)
        return a, -self.running_mean.float() * a


class SPADENorm(nn.Module):
    """SPADE's norm (``normalization.py::SPADE``): a param-free norm of x
    (``batch``, from its running statistics, or ``instance``) modulated by
    spatial γ/β convolved from the label map, nearest-resized to x's size.
    ``mlp_shared`` is SPADE's ``mlp_shared.0`` (its ReLU is applied here)."""

    def __init__(self, features: int, label_nc: int, hidden: int = 128,
                 param_free: str = "batch"):
        super().__init__()
        if param_free not in ("batch", "instance"):
            raise ValueError(f"param_free {param_free!r}: 'batch' or 'instance'")
        self.param_free = param_free
        if param_free == "batch":
            self.param_free_norm = RunningStats(features)
        self.mlp_shared = conv3x3(label_nc, hidden)
        self.mlp_gamma = conv3x3(hidden, features)
        self.mlp_beta = conv3x3(hidden, features)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        with annotate("s2p.spade.seg"):
            seg = F.interpolate(seg, size=x.shape[2:], mode="nearest")
        with annotate("s2p.mat.hidden"):
            h = F.relu(self.mlp_shared(seg))
        with annotate("s2p.mat.gb"):
            gamma, beta = self.mlp_gamma(h), self.mlp_beta(h)
        if self.param_free == "instance":
            return mat_norm_nchw(x, gamma, beta)
        return spade_norm_nchw(x, gamma, beta, *self.param_free_norm.folded())


class SPADEGenerator(nn.Module):
    """``netG=spade``: GauGAN (Park et al., CVPR 2019, arXiv:1903.07291;
    NVlabs/SPADE ``models/networks/generator.py::SPADEGenerator``), non-VAE.

    ``x = fc(seg at sh×sw)`` (a 3×3 conv, semantic_nc → 16·ngf), then the
    res blocks ``head_0`` (16·ngf), ``G_middle_0``, ``G_middle_1`` (16·ngf)
    and ``up_0..up_3`` (8, 4, 2, 1 ·ngf), each after a ×2 nearest upsample where SPADE has one, every norm a
    ``SPADENorm`` of the label map; ``tanh(conv_img(lrelu(x, 0.2)))``.
    The options are SPADE's (``label_nc``, ``contain_dontcare_label``,
    ``no_instance``, ``ngf``, ``crop_size``, ``aspect_ratio``,
    ``num_upsampling_layers``, ``norm_G``, ``nhidden``, ``use_vae``);
    ``semantic_nc`` = label_nc + dontcare (+ an edge map, not ported: the
    port takes ``no_instance=True`` only). Module names are SPADE's, so a
    SPADE checkpoint loads after ``convert.state_dict_from_spade`` (spectral
    norm folded).

    ``forward(seg)`` takes SPADE's ``input_semantics``, the one-hot map
    ``[B, semantic_nc, H, W]`` (``label_onehot``), and returns frames ``[B,
    H, W, 3]`` in [-1, 1]. It is the module path, for inference (the
    batch-norm modulation has no backward); the fast path is
    ``fast_inference.synthesize_fast``. The parameters start at PyTorch's
    default init: a caller loads weights (a SPADE checkpoint through
    ``convert.state_dict_from_spade``, or seeded ones). The module is built
    on ``device`` in channels_last memory."""

    def __init__(self, label_nc: int = 150, contain_dontcare_label: bool = True,
                 no_instance: bool = True, ngf: int = 64, crop_size: int = 256,
                 aspect_ratio: float = 1.0, num_upsampling_layers: str = "normal",
                 norm_G: str = "spectralspadesyncbatch3x3", nhidden: int = 128,
                 use_vae: bool = False, out_channels: int = 3,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if use_vae:
            raise ValueError("use_vae: the port has no SPADE image encoder (non-VAE only)")
        if not no_instance:
            raise ValueError("no_instance=False: the port takes no instance edge map")
        if num_upsampling_layers != "normal":
            raise ValueError(f"num_upsampling_layers {num_upsampling_layers!r}: the port "
                             "takes SPADE's 'normal' schedule only")
        self.param_free = parse_norm_g(norm_G)
        self.semantic_nc = label_nc + int(contain_dontcare_label)
        sw = crop_size // 2 ** UPSAMPLING_LAYERS
        self.latent_hw = (round(sw / aspect_ratio), sw)  # SPADE's (sh, sw)
        nf = ngf
        # (name, fin, fout, ×2 upsample before it), in SPADE's order
        sched = [("head_0", 16 * nf, 16 * nf, False), ("G_middle_0", 16 * nf, 16 * nf, True),
                 ("G_middle_1", 16 * nf, 16 * nf, False)]
        sched += [(f"up_{k}", c, c // 2, True) for k, c in enumerate((16 * nf, 8 * nf, 4 * nf,
                                                                      2 * nf))]
        self.schedule = sched
        self.fc = conv3x3(self.semantic_nc, 16 * nf)
        norm = lambda c: SPADENorm(c, self.semantic_nc, nhidden, self.param_free)
        for name, fin, fout, _ in sched:
            self.add_module(name, MATResBlock(fin, fout, norm=norm))
        self.conv_img = conv3x3(sched[-1][2], out_channels)
        self.to(device=device, memory_format=CL)

    @property
    def image_hw(self) -> Tuple[int, int]:
        """The output's (H, W): the latent grid doubled at every upsample."""
        ups = sum(up for *_, up in self.schedule)
        return self.latent_hw[0] * 2 ** ups, self.latent_hw[1] * 2 ** ups

    def forward(self, seg: torch.Tensor) -> torch.Tensor:
        """seg ``[B, semantic_nc, H, W]`` one-hot → frames ``[B, H, W, 3]``."""
        with annotate("s2p.gen.forward"):
            with annotate("s2p.gen.embed"):
                with annotate("s2p.spade.seg"):
                    x = F.interpolate(seg, size=self.latent_hw, mode="nearest")
                x = self.fc(x)
            for i, (name, _, _, up) in enumerate(self.schedule):
                if up:
                    with annotate("s2p.gen.upsample"):
                        x = F.interpolate(x, scale_factor=2, mode="nearest")
                with annotate(f"s2p.gen.block_{i}"):
                    x = getattr(self, name)(x, seg)
            with annotate("s2p.gen.head"):
                x = torch.tanh(self.conv_img(F.leaky_relu(x, 0.2)))
            return x.permute(0, 2, 3, 1)
