"""Fast generator apply: the constant-state-map modulation shortcut.

The port of ``s2p_tpu/gan/fast_inference.py``. Every MAT condition is
``state_map ‖ image_feat``, and ``state_map`` is a spatially constant
broadcast of the state embedding. A 3×3 zero-padded conv over a constant
map is a dense product for interior pixels plus corrections at the border
taps that fall outside the image:

    out(y, x) = e @ Σ_valid_taps K[ky, kx]

so the state half of each ``mlp_shared`` conv collapses to ONE
``[B,S]×[S,9·ΣF]`` matmul per generator step plus border assembly; only the
image half stays a real conv. Exact in arithmetic, reordered in float, so it
is a separate apply path held to the module path with a tolerance.

Tensors here are NCHW in channels_last memory, as in ``generator.py``. The
fast path runs an ``S2PGenerator``'s own layers, except that each MAT norm
reads operands that ``fuse_fast_params`` precomputes from the same weights.
A block's 2–3 norms condition on the same input, so their hidden maps come
from ONE wide shared conv, with the state half of every norm's terms
reduced in ONE matmul per step; one hand-written kernel then adds the
conv's bias and the border-aware constant-map terms, applies the ReLU and
writes each norm's map (``_hidden_maps``). The modulated instance norm
runs through the fused CUDA kernel on the card. The spans are the module
path's (``s2p.gen.*``, ``s2p.mat.*``), plus ``s2p.fast.cmap`` around each
block's hidden-map kernel with the constant-map terms and ``s2p.fast.fuse``
around the fusion of the operands.

``gb_int8`` (opt-in) runs each γ‖β conv on int8 operands: per-output-channel
int8 weights quantized once by ``fuse_fast_params(..., gb_int8=True)``,
activations quantized per sample at run time, an int32 product
(``torch._int_mm``, a library GEMM: the JAX package leaves this conv to XLA,
not to a Pallas kernel) and an f32 dequantization. Its frames differ from
the float path's by 8-bit quantization noise.

A ``SPADEGenerator`` (``netG=spade``) renders through ``synthesize_fast``:
its condition is a label map that varies over space, so the constant-map
shortcut does not apply, but the rest does: the same per-block fusion
(``_fuse_block``) and hidden-map step, the fused γ‖β conv per norm, then
the SPADE-norm kernel with the running statistics folded at fuse time.
The one-hot maps are made on the device from the label ids, per
resolution (spans ``s2p.spade.seg`` and ``s2p.spade.onehot``), with their
channels padded to a multiple of 8.

A ``StyleGANGenerator`` renders through ``synthesize_style_fast``: its
operands are folded once by the same ``fuse_fast_params``. The equalized
learning rate's scales go into the weights; every ``Conv0_up`` becomes ONE
4×4 stride-2 transposed conv (``stylegan.fused_up_kernel``: the official
fused op from 128² up, the nearest ×2 and 3×3 conv below it with the kernel
flipped); and the 18 style affines, the truncation ψ_i and ``dlatent_avg``
fold into ONE ``[dlatent, Σ 2C]`` GEMM over the mapping's output w
(``style_i = A_i·lerp(avg, w, ψ_i) + b_i = (ψ_i·A_i)·w + (b_i + (1 −
ψ_i)·A_i·avg)``), as S2P's state terms are one matmul for every norm.
The mapping and that GEMM run in float32 (a few MFLOP a pass), and the
styles are rounded once to the generator's type. Each layer's epilogue is
two hand-written kernels: the noise draw, then noise, bias and leaky ReLU in
one in-place pass (``cuda_kernels.style_epilogue``, span
``s2p.style.noise``); then the MAT-norm kernel with the layer's γ‖β slice
of the styles at pixel stride 0.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from s2p_tpu_torch.gan.cuda_kernels import hidden_maps, style_epilogue
from s2p_tpu_torch.gan.generator import (CL, S2PGenerator, SPADEGenerator, label_onehot,
                                         mat_norm_nchw, spade_norm_nchw, upsample_nearest)
from s2p_tpu_torch.gan.rollout import generate_rollout
from s2p_tpu_torch.gan.stylegan import (GAIN, LRELU, StyleGANGenerator, adain_nchw, blur_kernel,
                                        fused_up_kernel, layer_res, noise_map, pixel_norm,
                                        runtime_coef)
from s2p_tpu_torch.utils.profiling import annotate

Params = Dict[str, Any]
NORMS = ("norm_0", "norm_1", "norm_s")
LABEL_ALIGN = 8  # one-hot channels padded to a multiple of this: cuDNN's NHWC tensor-core convs


def _cl(t: torch.Tensor) -> torch.Tensor:
    """``t`` in channels_last memory (no copy when it already is)."""
    return t.contiguous(memory_format=CL)


def _const_map_terms(kernel: torch.Tensor) -> torch.Tensor:
    """Stack the 9 border-correction reductions of a ``[F, S, 3, 3]`` kernel
    into ONE ``[S, 9, F]`` operand. Order: full sum, top, bottom, left,
    right, then the 4 corner taps (00, 02, 20, 22)."""
    k = kernel.permute(2, 3, 1, 0)  # [ky, kx, S, F], as the JAX package holds it
    return torch.stack([
        k.sum((0, 1)),
        k[0].sum(0), k[2].sum(0),
        k[:, 0].sum(0), k[:, 2].sum(0),
        k[0, 0], k[0, 2], k[2, 0], k[2, 2],
    ], dim=1)


def _add_const_map(h: torch.Tensor, t: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add to ``h`` ``[B, F, H, W]``, in place, the constant-map conv output
    assembled from the reduced terms ``t = e @ terms`` ``[B, 9, F]`` (and a
    conv ``bias`` ``[F]``).

    Every pixel gets the full kernel sum; each border row and column then
    loses the tap row or column that falls outside the zero-padded image,
    and each corner gets back the tap it lost twice. The borders are
    updated through integer slices, so only border pixels are touched (the
    JAX package builds 0/1 masks that XLA fuses into one pass; in eager
    PyTorch each mask product would be a pass over the whole map). The fast
    path does the same in one kernel pass (``cuda_kernels.hidden_maps``)."""
    full, top, bot, left, right, c00, c02, c20, c22 = t.unbind(1)  # each [B, F]
    if bias is not None:
        full = full + bias
    h += full[:, :, None, None]
    h[:, :, 0] -= top[:, :, None]
    h[:, :, -1] -= bot[:, :, None]
    h[:, :, :, 0] -= left[:, :, None]
    h[:, :, :, -1] -= right[:, :, None]
    h[:, :, 0, 0] += c00
    h[:, :, 0, -1] += c02
    h[:, :, -1, 0] += c20
    h[:, :, -1, -1] += c22
    return h


def _const_map_from_t(t: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The constant-map conv output ``[B, F, H, W]`` (channels_last) from
    the reduced terms ``t = e @ terms`` ``[B, 9, F]``."""
    B, _, Fdim = t.shape
    out = torch.empty(B, Fdim, H, W, dtype=t.dtype, device=t.device, memory_format=CL)
    return _add_const_map(out.zero_(), t)


def _reduce_terms(e: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """``einsum('bs,snf->bnf')`` as one matmul: ``[B, 9, F]``."""
    S, n, Fdim = terms.shape
    return (e @ terms.reshape(S, n * Fdim)).reshape(-1, n, Fdim)


def conv_const_map(e: torch.Tensor, kernel: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """3×3 zero-padded conv (torch kernel ``[F, S, 3, 3]``) over the constant
    map ``broadcast(e)`` of size H×W, without materialising the map."""
    return _const_map_from_t(_reduce_terms(e, _const_map_terms(kernel)), H, W)


def _per_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` rounded as one true division on every device. PyTorch's
    CUDA kernel multiplies by the reciprocal of a Python-number divisor
    (the CPU's f32 kernel and XLA divide), which can differ in the last
    bit, and a scale one bit off flips 8-bit roundings."""
    return t / t.new_tensor(127.0)


def _quantize_gb_kernel(weight: torch.Tensor) -> Params:
    """Per-output-channel symmetric int8 quantization of a γ‖β conv weight
    ``[N, C, 3, 3]``: ``kernel_i8`` ``[9·C, N]`` int8, contiguous, its rows
    in (ky, kx, c) order as ``_im2col_3x3`` lays out the activations (the
    JAX package's HWIO kernel reshaped), and the f32 dequantization scale
    ``scale_w`` ``[N]``."""
    w = weight.float().permute(2, 3, 1, 0).reshape(-1, weight.shape[0])  # [(ky, kx, c), N]
    scale = _per_127(w.abs().amax(dim=0).clamp_min(1e-12))
    q = torch.clamp(torch.round(w / scale), -127, 127)
    return dict(kernel_i8=q.to(torch.int8).contiguous(), scale_w=scale)


def _fuse_block(block: torch.nn.Module, cond_weight: Callable[[torch.Tensor], torch.Tensor],
                gb_int8: bool = False) -> Params:
    """One res-block's fused operands, for either family. Per norm
    ``mlp_gb``: the γ and β convs as one conv over the hidden map; with
    ``gb_int8`` also ``mlp_gb_q``, that weight quantized to int8; for a
    SPADE batch norm ``scale``/``shift``, its running statistics folded in
    f32. Per block ``shared_cat``: the 2–3 norms of a block condition on the
    same input, so their ``mlp_shared`` convs run as ONE conv: its weight
    each norm's ``cond_weight(mlp_shared.weight)``, the part over the
    condition the fast path convolves, stacked in ``norms`` order; and
    ``widths``, each norm's share of the output."""
    norms = [n for n in NORMS if hasattr(block, n)]
    mods = [getattr(block, n) for n in norms]
    bp: Params = dict(norms=norms, shared_cat=dict(
        weight=_cl(torch.cat([cond_weight(m.mlp_shared.weight) for m in mods], 0)),
        bias=torch.cat([m.mlp_shared.bias for m in mods], 0),
        widths=[m.mlp_shared.bias.shape[0] for m in mods]))
    for n, m in zip(norms, mods):
        gb = dict(weight=_cl(torch.cat([m.mlp_gamma.weight, m.mlp_beta.weight], 0)),
                  bias=torch.cat([m.mlp_gamma.bias, m.mlp_beta.bias], 0))
        bp[n] = dict(mlp_gb=gb)
        if gb_int8:
            bp[n]["mlp_gb_q"] = _quantize_gb_kernel(gb["weight"])
        if getattr(m, "param_free", None) == "batch":
            bp[n]["scale"], bp[n]["shift"] = m.param_free_norm.folded()
    return bp


@torch.no_grad()
def fuse_fast_params(gen: S2PGenerator | SPADEGenerator | StyleGANGenerator,
                     gb_int8: bool = False) -> Params:
    """Precompute, once and outside the rollout loop, the fused operands the
    fast path reads beside ``gen``'s own layers: per block ``_fuse_block``'s.
    The two families differ in what a block's shared conv runs over.

    An ``S2PGenerator``'s runs over the image feature only: ``shared_cat``
    holds the image half ``[:, S:]`` of each ``mlp_shared`` weight, and the
    state half ``[:, :S]`` goes into top-level ``cmap_terms_all`` ``[S, 9,
    ΣF]``, every norm's constant-map terms in (block, norm_0, norm_1, norm_s)
    order, so the whole network's state modulation is ONE matmul per step.
    ``gb_int8`` adds the int8 γ‖β weights for the opt-in int8 modulation;
    the float operands stay, so the float path is unchanged.

    A ``SPADEGenerator``'s runs over the one-hot label map, whose width,
    ``label_channels``, is ``semantic_nc`` padded to ``LABEL_ALIGN``: the
    weights' extra inputs (``shared_cat``'s and ``fc``'s) are zero, so the
    sums are unchanged. It runs in float only.

    A ``StyleGANGenerator``'s are ``_fuse_style``'s (float only too)."""
    if isinstance(gen, StyleGANGenerator):
        if gb_int8:
            raise ValueError("the StyleGAN fast path runs in float only")
        with annotate("s2p.fast.fuse"):
            return _fuse_style(gen)
    if isinstance(gen, SPADEGenerator):
        if gb_int8:
            raise ValueError("the SPADE fast path runs in float only")
        with annotate("s2p.fast.fuse"):
            cp = -(-gen.semantic_nc // LABEL_ALIGN) * LABEL_ALIGN
            return dict(blocks=[_fuse_block(getattr(gen, name), lambda w: _pad_inputs(w, cp))
                                for name, *_ in gen.schedule],
                        label_channels=cp,
                        fc=dict(weight=_pad_inputs(gen.fc.weight, cp), bias=gen.fc.bias))
    if gen.mat_mode != "mat":
        raise ValueError(f"the fast path specializes the MAT layout, not {gen.mat_mode!r}")
    with annotate("s2p.fast.fuse"):
        S = gen.state_fc1.weight.shape[0]
        blocks = [getattr(gen, f"block_{i}") for i in range(len(gen.sizes))]
        fused = [_fuse_block(b, lambda w: w[:, S:], gb_int8) for b in blocks]
        terms = [_const_map_terms(getattr(b, n).mlp_shared.weight[:, :S])
                 for b, bp in zip(blocks, fused) for n in bp["norms"]]
        return dict(blocks=fused, cmap_terms_all=torch.cat(terms, -1))


def _im2col_3x3(q: torch.Tensor) -> torch.Tensor:
    """The ``[B·H·W, 9·C]`` patches of a 3×3 zero-padded conv over NHWC
    ``q`` (any type: ``F.unfold`` has no int8 version), columns in (ky, kx,
    c) order, built from 9 shifted slices of one padded copy."""
    B, H, W, C = q.shape
    padded = q.new_zeros(B, H + 2, W + 2, C)
    padded[:, 1:-1, 1:-1] = q
    cols = torch.cat([padded[:, ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3)],
                     dim=-1)
    return cols.reshape(B * H * W, 9 * C)


def _conv_gb_int8(h: torch.Tensor, q: Params, bias: torch.Tensor) -> torch.Tensor:
    """The γ‖β conv over NCHW ``h`` on int8 operands: activations quantized
    per sample (symmetric absmax, round half to even, clipped to ±127), an
    im2col product with the int8 weight accumulated in int32 (exact while
    127²·K < 2³¹; K = 9·C is 1,152 at full width), then ``acc · (s_h·scale_w) +
    bias`` in f32, cast back to h's type; NCHW in channels_last out.
    ``torch._int_mm`` on the card needs more than 16 rows and K, N
    multiples of 8, so a product of 16 rows or fewer (the 4×4 seed block at
    batch 1) is padded to 17; both operands are contiguous, the layout its
    cuBLASLt path takes."""
    hf = h.float().permute(0, 2, 3, 1)  # NHWC
    B, H, W, _ = hf.shape
    s_h = _per_127(hf.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12))
    qh = torch.clamp(torch.round(hf / s_h), -127, 127).to(torch.int8)
    cols = _im2col_3x3(qh)
    M = cols.shape[0]
    if M <= 16:
        cols = torch.cat([cols, cols.new_zeros(17 - M, cols.shape[1])])
    acc = torch._int_mm(cols, q["kernel_i8"])[:M].reshape(B, H, W, -1)
    out = acc.float() * (s_h * q["scale_w"]) + bias.float()
    return out.to(h.dtype).permute(0, 3, 1, 2)


def _modulate(x: torch.Tensor, h: torch.Tensor, p: Params, gb_int8: bool = False
              ) -> torch.Tensor:
    """γ‖β conv over the norm's hidden map ``h`` (on int8 operands with
    ``gb_int8``), then the modulated norm (instance statistics, or the
    folded running statistics ``scale``/``shift`` of a SPADE batch norm),
    with γ and β read in place as the conv output's two channel halves.
    The float conv runs without its bias: the norm kernel adds it to γ and
    β as it reads them, which saves a pass over the 2C-channel map (the
    int8 conv adds it in its own f32 epilogue)."""
    if gb_int8 and "mlp_gb_q" not in p:
        raise ValueError("gb_int8=True needs the int8 operands: fuse the parameters with "
                         "fuse_fast_params(gen, gb_int8=True)")
    bias = p["mlp_gb"]["bias"]
    with annotate("s2p.mat.gb"):
        if gb_int8:
            gb, bias = _conv_gb_int8(h, p["mlp_gb_q"], bias), None
        else:
            gb = _cl(F.conv2d(_cl(h), p["mlp_gb"]["weight"], None, padding=1))
    C = gb.shape[1] // 2
    if "scale" in p:  # SPADE's batch norm, its running statistics folded
        return spade_norm_nchw(x, gb[:, :C], gb[:, C:], p["scale"], p["shift"], bias)
    return mat_norm_nchw(x, gb[:, :C], gb[:, C:], bias)


def _hidden_maps(cond: torch.Tensor, p: Params,
                 state_terms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A block's hidden maps, one per norm, in one pass: ONE conv over the
    condition ``cond`` (S2P's image feature, SPADE's one-hot label map),
    without its bias; then ``cuda_kernels.hidden_maps`` adds the bias and,
    for S2P, the constant-map terms ``state_terms`` ``[B, 9, ΣF]`` of the
    state half, applies the ReLU and writes each norm's map, split by the
    fused widths, channels_last-contiguous (one kernel launch on the card).
    The caller opens ``s2p.mat.hidden`` around it, so that SPADE's one-hot
    maps, made at their first use, count there."""
    sc = p["shared_cat"]
    h = F.conv2d(cond, sc["weight"], None, padding=1)
    if state_terms is None:
        maps = hidden_maps(h, sc["bias"], sc["widths"])
    else:
        with annotate("s2p.fast.cmap"):
            maps = hidden_maps(h, sc["bias"], sc["widths"], state_terms)
    return dict(zip(p["norms"], maps))


def _res_block(x: torch.Tensor, block: torch.nn.Module, norm) -> torch.Tensor:
    """``MATResBlock.forward`` with ``norm(x, name)`` in place of the block's
    norms; ``block`` supplies the res-block convs."""
    h = block.conv_0(F.leaky_relu(norm(x, "norm_0"), 0.2))
    h = block.conv_1(F.leaky_relu(norm(h, "norm_1"), 0.2))
    s = block.conv_s(norm(x, "norm_s")) if hasattr(block, "conv_s") else x
    return s + h


@torch.no_grad()
def fast_apply(gen: S2PGenerator, params: Params, state: torch.Tensor,
               prev_image: torch.Tensor, gb_int8: bool = False) -> torch.Tensor:
    """Drop-in for ``gen(state, prev_image)`` (mat_mode 'mat' only), NHWC
    in and out, with ``params = fuse_fast_params(gen, ...)``: the same
    weights, the same output up to float re-association. The encoder, the
    state embedding, the seed map, the res-block convs and the head are
    ``gen``'s own layers; only the MAT norms take the shortcut. ``gb_int8``
    runs the γ‖β convs on int8 operands and needs ``params`` fused with
    ``gb_int8=True`` (else it raises: the JAX package would run the float
    path instead)."""
    with annotate("s2p.gen.forward"):
        sizes = gen.sizes
        with annotate("s2p.gen.encode"):
            feats = gen.img_enc(prev_image.permute(0, 3, 1, 2))
        enc_by_size = {f.shape[-1]: f for f in feats}
        with annotate("s2p.gen.embed"):
            e = gen.embed_state(state)
            x = gen.seed_map(e)
            # the whole network's state-side reduction in ONE matmul, sliced per block
            t_all = _reduce_terms(e, params["cmap_terms_all"])
        off = 0
        for i, size in enumerate(sizes):
            p = params["blocks"][i]
            w = p["shared_cat"]["weight"].shape[0]
            t_blk = t_all[:, :, off:off + w]
            off += w
            with annotate(f"s2p.gen.block_{i}"):
                with annotate("s2p.mat.hidden"):
                    hmaps = _hidden_maps(enc_by_size[size], p, t_blk)
                x = _res_block(x, getattr(gen, f"block_{i}"),
                               lambda t, n: _modulate(t, hmaps[n], p[n], gb_int8))
            if i < len(sizes) - 1:
                with annotate("s2p.gen.upsample"):
                    x = upsample_nearest(x, sizes[i + 1])
        with annotate("s2p.gen.head"):
            x = torch.tanh(gen.conv_img(F.leaky_relu(x, 0.2)))
        return x.permute(0, 2, 3, 1)


@torch.no_grad()
def generate_rollout_fast(gen: S2PGenerator, init_image: torch.Tensor,
                          states: torch.Tensor, gb_int8: bool = False) -> torch.Tensor:
    """``generate_rollout`` with ``fast_apply`` as the step: init_image
    ``[B, H, W, C]``, states ``[T, B, S]`` (s_{t+1} for each step) → frames
    ``[T, B, H, W, C]``. The weights are fused once, before the loop;
    ``gb_int8`` runs the int8 γ‖β convs."""
    params = fuse_fast_params(gen, gb_int8=gb_int8)
    return generate_rollout(lambda s, img: fast_apply(gen, params, s, img, gb_int8),
                            init_image, states)


# -- netG=spade ------------------------------------------------------------------

def _pad_inputs(weight: torch.Tensor, channels: int) -> torch.Tensor:
    """A conv weight ``[O, I, k, k]`` with its inputs zero-padded to
    ``channels``, in channels_last memory."""
    pad = weight.new_zeros(weight.shape[0], channels - weight.shape[1], *weight.shape[2:])
    return _cl(torch.cat([weight, pad], 1))


def downsample_ids(ids: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Label ids ``[B, H, W]`` nearest-resized to ``hw`` by PyTorch's index
    rule, ``src = floor(dst·in/out)``, which at an integer ratio s is every
    s-th id from the first (a view): the ids of ``F.interpolate(onehot,
    hw, mode="nearest")``'s one-hot map."""
    (H, W), (h, w) = ids.shape[1:], hw
    if H % h or W % w:
        raise ValueError(f"downsample_ids: {H}×{W} → {h}×{w} is not an integer ratio")
    return ids[:, :: H // h, :: W // w]


@torch.no_grad()
def synthesize_fast(gen: SPADEGenerator, label_ids: torch.Tensor,
                    params: Optional[Params] = None) -> torch.Tensor:
    """The SPADE generator's fast path: integer label ids ``[B, H, W]``
    (H×W = ``gen.image_hw``) → frames ``[B, H, W, 3]``, the module path's
    ``gen(label_onehot(ids, gen.semantic_nc))`` up to float re-association.
    ``params`` = ``fuse_fast_params(gen)``, fused here when not given. Per
    resolution the ids are downsampled and scattered into a one-hot map on
    the device, once; per block ONE shared conv over it gives every norm's
    hidden map; per norm the fused γ‖β conv and the modulation kernel. The
    res-block convs, upsampling and head are ``gen``'s own layers."""
    if not isinstance(gen, SPADEGenerator):
        raise TypeError(f"synthesize_fast takes a SPADEGenerator, not {type(gen).__name__}")
    if tuple(label_ids.shape[1:]) != gen.image_hw:
        raise ValueError(f"label ids {tuple(label_ids.shape)}: the generator renders "
                         f"{gen.image_hw}")
    params = params or fuse_fast_params(gen)
    dtype, cp = gen.fc.weight.dtype, params["label_channels"]
    maps: Dict[Tuple[int, int], torch.Tensor] = {}

    def seg_at(hw: Tuple[int, int]) -> torch.Tensor:
        if hw not in maps:
            with annotate("s2p.spade.seg"):
                ids = downsample_ids(label_ids, hw)
            with annotate("s2p.spade.onehot"):
                maps[hw] = label_onehot(ids, cp, dtype)
        return maps[hw]

    with annotate("s2p.gen.forward"):
        with annotate("s2p.gen.embed"):
            fc = params["fc"]
            x = F.conv2d(seg_at(gen.latent_hw), fc["weight"], fc["bias"], padding=1)
        for i, (name, _, _, up) in enumerate(gen.schedule):
            if up:
                with annotate("s2p.gen.upsample"):
                    x = F.interpolate(x, scale_factor=2, mode="nearest")
            p = params["blocks"][i]
            with annotate(f"s2p.gen.block_{i}"):
                with annotate("s2p.mat.hidden"):
                    hmaps = _hidden_maps(seg_at(tuple(x.shape[2:])), p)
                x = _res_block(x, getattr(gen, name),
                               lambda t, n: _modulate(t, hmaps[n], p[n]))
        with annotate("s2p.gen.head"):
            x = torch.tanh(gen.conv_img(F.leaky_relu(x, 0.2)))
        return x.permute(0, 2, 3, 1)


# -- StyleGAN ----------------------------------------------------------------------

def _fuse_style(gen: StyleGANGenerator) -> Params:
    """StyleGAN's fused operands: ``mapping``, each dense layer's scaled
    weight ``[in, out]`` and bias in f32; ``style``, the 18 affines with ψ_i
    and ``dlatent_avg`` folded (``weight`` ``[dlatent, Σ 2C]``, ``bias``
    ``[Σ 2C]``, f32); per resolution the ``blocks``' two layers, each with
    its conv (``const``, or ``weight``: a 3×3 kernel, or an up-conv's 4×4
    transposed kernel), ``noise`` (the strength) and ``bias`` ``[C]`` and its
    ``style`` slice; the ``blur`` kernel of each up layer; ``torgb``. Conv
    weights are scaled in f32, then cast to the generator's type in
    channels_last memory."""
    layers, specs = gen.layers(), gen.layer_specs
    dtype = layers[1].weight.dtype
    cast = lambda t: _cl(t.to(dtype)) if t.dim() == 4 else t.to(dtype)
    mapping = [((d.weight.float() * runtime_coef(d.weight.shape, GAIN, d.lrmul)).t().contiguous(),
                d.bias.float() * d.lrmul) for d in gen.G_mapping.children()]
    avg = gen.dlatent_avg.float()
    a_w, a_b, fused, off = [], [], [], 0
    for i, (layer, (_, _, kind, _, c_out)) in enumerate(zip(layers, specs)):
        sm = layer.StyleMod
        A = sm.weight.float() * runtime_coef(sm.weight.shape, 1.0)  # [2C, dlatent]
        psi = gen.psi(i)
        a_w.append(psi * A)
        a_b.append(sm.bias.float() + (1.0 - psi) * (A @ avg))
        lp: Params = dict(kind=kind, style=(off, c_out),
                          noise=layer.Noise.weight.to(dtype).contiguous(),
                          bias=layer.bias.to(dtype).contiguous())
        off += 2 * c_out
        if kind == "const":
            lp["const"] = cast(layer.const)
        else:
            w = layer.weight.float() * runtime_coef(layer.weight.shape, GAIN)
            if kind == "up":  # one transposed conv: the official fused op, or nearest + conv
                w = fused_up_kernel(w if gen.fused(layer_res(i)) else w.flip(2, 3))
                lp["blur"] = cast(blur_kernel(c_out, gen.blur_filter, device=w.device))
            lp["weight"] = cast(w)
        fused.append(lp)
    rgb = gen.G_synthesis.ToRGB_lod0
    return dict(
        mapping=mapping,
        style=dict(weight=torch.cat(a_w).t().contiguous(), bias=torch.cat(a_b)),
        blocks=[fused[i:i + 2] for i in range(0, len(fused), 2)],
        torgb=dict(weight=cast(rgb.weight.float() * runtime_coef(rgb.weight.shape, 1.0)),
                   bias=rgb.bias.to(dtype)),
        dtype=dtype, latent_size=gen.latent_size)


def _style_layer(x: torch.Tensor, lp: Params, styles: torch.Tensor, layer: int,
                 noise_gen: Optional[torch.Generator]) -> torch.Tensor:
    """One synthesis layer on the fast path: its conv (the constant, a 3×3
    conv, or the up layer's transposed conv and blur), then the epilogue:
    noise, bias and leaky ReLU in place (the style-epilogue kernel), then
    AdaIN on the MAT-norm kernel."""
    B = styles.shape[0]
    if lp["kind"] == "const":  # a copy: the epilogue writes it in place
        x = lp["const"].expand(B, -1, -1, -1).clone(memory_format=CL)
    elif lp["kind"] == "conv":
        x = _cl(F.conv2d(x, lp["weight"], None, padding=1))
    else:
        with annotate("s2p.gen.upsample"):
            x = F.conv_transpose2d(x, lp["weight"], None, stride=2, padding=1)
            x = _cl(F.conv2d(_cl(x), lp["blur"], None, padding=1, groups=x.shape[1]))
    with annotate("s2p.style.noise"):
        n = noise_map(B, layer, noise_gen, x.device)
        style_epilogue(x.permute(0, 2, 3, 1), n.view(B, *n.shape[2:]), lp["noise"], lp["bias"],
                       LRELU)
    off, C = lp["style"]
    return adain_nchw(x, styles[:, off:off + 2 * C])


@torch.no_grad()
def synthesize_style_fast(gen: StyleGANGenerator, z: torch.Tensor,
                          noise_gen: Optional[torch.Generator] = None,
                          params: Optional[Params] = None) -> torch.Tensor:
    """StyleGAN's fast path: latents ``[B, latent_size]`` → frames ``[B, R,
    R, num_channels]`` (NHWC, channels_last underneath), ``gen(z,
    noise_gen)`` up to float re-association, with the same noise: each
    layer's map is drawn from ``noise_gen`` in layer order. ``params`` =
    ``fuse_fast_params(gen)``, fused here when not given. The mapping (pixel
    norm, 8 dense layers) and ONE style GEMM run in f32 (``s2p.style.mapping``);
    then per resolution (``s2p.gen.block_<i>``) two layers of
    ``_style_layer``; then toRGB (``s2p.gen.head``)."""
    if not isinstance(gen, StyleGANGenerator):
        raise TypeError(f"synthesize_style_fast takes a StyleGANGenerator, not "
                        f"{type(gen).__name__}")
    params = params or fuse_fast_params(gen)
    if z.dim() != 2 or z.shape[1] != params["latent_size"]:
        raise ValueError(f"latents {tuple(z.shape)}: the generator takes [B, "
                         f"{params['latent_size']}]")
    with annotate("s2p.gen.forward"):
        with annotate("s2p.style.mapping"):
            w = pixel_norm(z.float())
            for weight, bias in params["mapping"]:
                w = F.leaky_relu(torch.addmm(bias, w, weight), LRELU)
            st = params["style"]
            styles = torch.addmm(st["bias"], w, st["weight"]).to(params["dtype"])
        x = None
        for i, pair in enumerate(params["blocks"]):
            with annotate(f"s2p.gen.block_{i}"):
                for j, lp in enumerate(pair):
                    x = _style_layer(x, lp, styles, 2 * i + j, noise_gen)
        with annotate("s2p.gen.head"):
            rgb = params["torgb"]
            x = F.conv2d(x, rgb["weight"], rgb["bias"])
        return x.permute(0, 2, 3, 1)
