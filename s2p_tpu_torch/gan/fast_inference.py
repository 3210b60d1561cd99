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
The modulated instance norm runs through the fused CUDA kernel on the card.
The spans are the module path's (``s2p.gen.*``, ``s2p.mat.*``), plus
``s2p.fast.cmap`` around each constant-map assembly and ``s2p.fast.fuse``
around the fusion of the operands.

``gb_int8`` (opt-in) runs each γ‖β conv on int8 operands: per-output-channel
int8 weights quantized once by ``fuse_fast_params(..., gb_int8=True)``,
activations quantized per sample at run time, an int32 product
(``torch._int_mm``, a library GEMM: the JAX package leaves this conv to XLA,
not to a Pallas kernel) and an f32 dequantization. Its frames differ from
the float path's by 8-bit quantization noise.

A ``SPADEGenerator`` (``netG=spade``) renders through ``synthesize_fast``:
its condition is a label map that varies over space, so the constant-map
shortcut does not apply, but the block-level fusion does: each of a
block's 2–3 norms sees the same map, so one wide shared conv (split per
norm) and the fused γ‖β conv per norm, then the SPADE-norm kernel with the
running statistics folded at fuse time. The one-hot maps are made on the
device from the label ids, per resolution (spans ``s2p.spade.seg`` and
``s2p.spade.onehot``), with their channels padded to a multiple of 8.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from s2p_tpu_torch.gan.generator import (CL, S2PGenerator, SPADEGenerator, label_onehot,
                                         mat_norm_nchw, spade_norm_nchw, upsample_nearest)
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
    PyTorch each mask product would be a pass over the whole map)."""
    with annotate("s2p.fast.cmap"):
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


def _norm_params(norm: torch.nn.Module, S: int, gb_int8: bool = False) -> Params:
    """Per-norm fusions: γ‖β conv ``mlp_gb``, the state half's constant-map
    terms, the image half ``k_img`` of ``mlp_shared`` and, with ``gb_int8``,
    the quantized γ‖β weight ``mlp_gb_q``."""
    k = norm.mlp_shared.weight  # [hidden, S + C_img, 3, 3]
    p = dict(
        mlp_shared_bias=norm.mlp_shared.bias,
        mlp_gb=dict(weight=_cl(torch.cat([norm.mlp_gamma.weight, norm.mlp_beta.weight], 0)),
                    bias=torch.cat([norm.mlp_gamma.bias, norm.mlp_beta.bias], 0)),
        cmap_terms=_const_map_terms(k[:, :S]),
        k_img=_cl(k[:, S:]),
    )
    if gb_int8:
        p["mlp_gb_q"] = _quantize_gb_kernel(p["mlp_gb"]["weight"])
    return p


@torch.no_grad()
def fuse_fast_params(gen: S2PGenerator | SPADEGenerator, block_level: bool = True,
                     gb_int8: bool = False) -> Params:
    """Precompute, once and outside the rollout loop, the fused operands the
    fast path reads beside ``gen``'s own layers.

    Per norm: ``mlp_gb`` (γ and β convs as one conv over ``h``),
    ``cmap_terms`` and ``k_img``. With ``block_level`` also, per block,
    ``shared_cat``: the 2–3 norms of a block condition on the same inputs,
    so their image-half convs run as ONE conv; and top-level
    ``cmap_terms_all`` ``[S, 9, ΣF]``: every norm's state terms in (block,
    norm_0, norm_1, norm_s) order, so the whole network's state modulation
    is ONE matmul per step. ``block_level=False`` keeps only the per-norm
    fusions: the block-level concat holds a 2–3× wider hidden map, which
    costs memory at very large batch. ``gb_int8`` adds, per norm,
    ``mlp_gb_q``: the γ‖β weight quantized to int8 for the opt-in int8
    modulation; the float operands stay, so the float path is unchanged.

    A ``SPADEGenerator`` gets its own operands (``_fuse_spade``): block-level
    fusion only, no int8."""
    if isinstance(gen, SPADEGenerator):
        if gb_int8 or not block_level:
            raise ValueError("the SPADE fast path runs block-level fusion in float only")
        return _fuse_spade(gen)
    if gen.mat_mode != "mat":
        raise ValueError(f"the fast path specializes the MAT layout, not {gen.mat_mode!r}")
    with annotate("s2p.fast.fuse"):
        S = gen.state_fc1.weight.shape[0]
        blocks: List[Params] = []
        all_terms: List[torch.Tensor] = []
        for i in range(len(gen.sizes)):
            block = getattr(gen, f"block_{i}")
            norms = [n for n in NORMS if hasattr(block, n)]
            bp: Params = dict(norms=norms, **{n: _norm_params(getattr(block, n), S, gb_int8)
                                              for n in norms})
            if block_level:
                bp["shared_cat"] = dict(
                    weight=_cl(torch.cat([bp[n]["k_img"] for n in norms], 0)),
                    bias=torch.cat([bp[n]["mlp_shared_bias"] for n in norms], 0))
                all_terms.extend(bp[n]["cmap_terms"] for n in norms)
            blocks.append(bp)
        p: Params = dict(blocks=blocks)
        if all_terms:
            p["cmap_terms_all"] = torch.cat(all_terms, -1)
    return p


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
    with γ and β read in place as the conv output's two channel halves."""
    if gb_int8 and "mlp_gb_q" not in p:
        raise ValueError("gb_int8=True needs the int8 operands: fuse the parameters with "
                         "fuse_fast_params(gen, gb_int8=True)")
    with annotate("s2p.mat.gb"):
        if gb_int8:
            gb = _conv_gb_int8(h, p["mlp_gb_q"], p["mlp_gb"]["bias"])
        else:
            gb = _cl(F.conv2d(_cl(h), p["mlp_gb"]["weight"], p["mlp_gb"]["bias"], padding=1))
    C = gb.shape[1] // 2
    if "scale" in p:  # SPADE's batch norm, its running statistics folded
        return spade_norm_nchw(x, gb[:, :C], gb[:, C:], p["scale"], p["shift"])
    return mat_norm_nchw(x, gb[:, :C], gb[:, C:])


def _mat_norm_fast(x: torch.Tensor, e: torch.Tensor, image_feat: torch.Tensor,
                   p: Params, gb_int8: bool = False) -> torch.Tensor:
    """MATNorm with the shared conv split: state half by the constant-map
    shortcut, image half as a real conv."""
    with annotate("s2p.mat.hidden"):
        h = F.conv2d(image_feat, p["k_img"], padding=1)
        h = _add_const_map(h, _reduce_terms(e, p["cmap_terms"]), p["mlp_shared_bias"]).relu_()
    return _modulate(x, h, p, gb_int8)


def _block_hidden_maps(image_feat: torch.Tensor, t_blk: torch.Tensor, p: Params,
                       norms: List[str]) -> List[torch.Tensor]:
    """All of a block's hidden maps in one pass: ONE conv over
    ``image_feat`` plus the pre-reduced state terms ``t_blk``, split back
    per norm."""
    with annotate("s2p.mat.hidden"):
        sc = p["shared_cat"]
        h = _add_const_map(F.conv2d(image_feat, sc["weight"], padding=1), t_blk,
                           sc["bias"]).relu_()
        widths = [p[n]["mlp_shared_bias"].shape[0] for n in norms]
        return list(torch.split(h, widths, dim=1))


def _res_block(x: torch.Tensor, block: torch.nn.Module, norm) -> torch.Tensor:
    """``MATResBlock.forward`` with ``norm(x, name)`` in place of the block's
    norms; ``block`` supplies the res-block convs."""
    h = block.conv_0(F.leaky_relu(norm(x, "norm_0"), 0.2))
    h = block.conv_1(F.leaky_relu(norm(h, "norm_1"), 0.2))
    s = block.conv_s(norm(x, "norm_s")) if hasattr(block, "conv_s") else x
    return s + h


def _res_block_fast(x: torch.Tensor, e: torch.Tensor, image_feat: torch.Tensor,
                    block: torch.nn.Module, p: Params,
                    t_blk: Optional[torch.Tensor] = None, gb_int8: bool = False
                    ) -> torch.Tensor:
    """``MATResBlock.forward`` with the fast MAT norms; ``block`` supplies
    the res-block convs, ``p`` the block's fused operands."""
    norms = p["norms"]
    if t_blk is not None and "shared_cat" in p:
        hmaps = dict(zip(norms, _block_hidden_maps(image_feat, t_blk, p, norms)))
        mat_norm = lambda x, n: _modulate(x, hmaps[n], p[n], gb_int8)
    else:
        mat_norm = lambda x, n: _mat_norm_fast(x, e, image_feat, p[n], gb_int8)
    return _res_block(x, block, mat_norm)


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
            t_all = (_reduce_terms(e, params["cmap_terms_all"]) if "cmap_terms_all" in params
                     else None)
        off = 0
        for i, size in enumerate(sizes):
            blk = params["blocks"][i]
            t_blk = None
            if t_all is not None and "shared_cat" in blk:
                w = blk["shared_cat"]["weight"].shape[0]
                t_blk = t_all[:, :, off:off + w]
                off += w
            with annotate(f"s2p.gen.block_{i}"):
                x = _res_block_fast(x, e, enc_by_size[size], getattr(gen, f"block_{i}"), blk,
                                    t_blk, gb_int8)
            if i < len(sizes) - 1:
                with annotate("s2p.gen.upsample"):
                    x = upsample_nearest(x, sizes[i + 1])
        with annotate("s2p.gen.head"):
            x = torch.tanh(gen.conv_img(F.leaky_relu(x, 0.2)))
        return x.permute(0, 2, 3, 1)


@torch.no_grad()
def generate_rollout_fast(gen: S2PGenerator, init_image: torch.Tensor,
                          states: torch.Tensor, block_fusion: bool = True,
                          gb_int8: bool = False) -> torch.Tensor:
    """``seq_len`` autoregressive steps with ``fast_apply``: init_image
    ``[B, H, W, C]``, states ``[T, B, S]`` (s_{t+1} for each step) →
    frames ``[T, B, H, W, C]``. The weights are fused once, before the
    loop; ``block_fusion`` toggles the block-level fusion (see
    ``fuse_fast_params``), ``gb_int8`` the int8 γ‖β convs."""
    params = fuse_fast_params(gen, block_level=block_fusion, gb_int8=gb_int8)
    frames = []
    img = init_image
    for s in states:
        img = fast_apply(gen, params, s, img, gb_int8)
        frames.append(img)
    return torch.stack(frames)


# -- netG=spade ------------------------------------------------------------------

def _pad_inputs(weight: torch.Tensor, channels: int) -> torch.Tensor:
    """A conv weight ``[O, I, k, k]`` with its inputs zero-padded to
    ``channels``, in channels_last memory."""
    pad = weight.new_zeros(weight.shape[0], channels - weight.shape[1], *weight.shape[2:])
    return _cl(torch.cat([weight, pad], 1))


def _fuse_spade(gen: SPADEGenerator) -> Params:
    """A ``SPADEGenerator``'s fast-path operands: per block ``shared_cat``
    (its norms' ``mlp_shared`` as ONE conv over the label map, their widths
    in ``norms`` order) and per norm ``mlp_gb`` (γ and β convs as one) and,
    for a batch norm, the folded f32 statistics ``scale``/``shift``; ``fc``;
    and ``label_channels``, the one-hot width padded to ``LABEL_ALIGN``
    (the padded weights' extra inputs are zero, so the sums are unchanged)."""
    with annotate("s2p.fast.fuse"):
        cp = -(-gen.semantic_nc // LABEL_ALIGN) * LABEL_ALIGN
        blocks: List[Params] = []
        for name, *_ in gen.schedule:
            block = getattr(gen, name)
            norms = [n for n in NORMS if hasattr(block, n)]
            bp: Params = dict(norms=norms)
            for n in norms:
                m = getattr(block, n)
                bp[n] = dict(
                    mlp_shared_bias=m.mlp_shared.bias,
                    mlp_gb=dict(weight=_cl(torch.cat([m.mlp_gamma.weight, m.mlp_beta.weight], 0)),
                                bias=torch.cat([m.mlp_gamma.bias, m.mlp_beta.bias], 0)))
                if m.param_free == "batch":
                    bp[n]["scale"], bp[n]["shift"] = m.param_free_norm.folded()
            bp["shared_cat"] = dict(
                weight=_pad_inputs(torch.cat([getattr(block, n).mlp_shared.weight
                                              for n in norms], 0), cp),
                bias=torch.cat([bp[n]["mlp_shared_bias"] for n in norms], 0))
            blocks.append(bp)
        return dict(blocks=blocks, label_channels=cp,
                    fc=dict(weight=_pad_inputs(gen.fc.weight, cp), bias=gen.fc.bias))


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
                    sc = p["shared_cat"]
                    h = F.conv2d(seg_at(tuple(x.shape[2:])), sc["weight"], sc["bias"],
                                 padding=1).relu_()
                    widths = [p[n]["mlp_shared_bias"].shape[0] for n in p["norms"]]
                    hmaps = dict(zip(p["norms"], torch.split(h, widths, dim=1)))
                x = _res_block(x, getattr(gen, name),
                               lambda t, n: _modulate(t, hmaps[n], p[n]))
        with annotate("s2p.gen.head"):
            x = torch.tanh(gen.conv_img(F.leaky_relu(x, 0.2)))
        return x.permute(0, 2, 3, 1)
