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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from s2p_tpu_torch.gan.generator import CL, S2PGenerator, mat_norm_nchw, upsample_nearest

Params = Dict[str, Any]
NORMS = ("norm_0", "norm_1", "norm_s")


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


def _norm_params(norm: torch.nn.Module, S: int) -> Params:
    """Per-norm fusions: γ‖β conv ``mlp_gb``, the state half's constant-map
    terms, and the image half ``k_img`` of ``mlp_shared``."""
    k = norm.mlp_shared.weight  # [hidden, S + C_img, 3, 3]
    return dict(
        mlp_shared_bias=norm.mlp_shared.bias,
        mlp_gb=dict(weight=_cl(torch.cat([norm.mlp_gamma.weight, norm.mlp_beta.weight], 0)),
                    bias=torch.cat([norm.mlp_gamma.bias, norm.mlp_beta.bias], 0)),
        cmap_terms=_const_map_terms(k[:, :S]),
        k_img=_cl(k[:, S:]),
    )


@torch.no_grad()
def fuse_fast_params(gen: S2PGenerator, block_level: bool = True) -> Params:
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
    costs memory at very large batch."""
    if gen.mat_mode != "mat":
        raise ValueError(f"the fast path specializes the MAT layout, not {gen.mat_mode!r}")
    S = gen.state_fc1.weight.shape[0]
    blocks: List[Params] = []
    all_terms: List[torch.Tensor] = []
    for i in range(len(gen.sizes)):
        block = getattr(gen, f"block_{i}")
        norms = [n for n in NORMS if hasattr(block, n)]
        bp: Params = dict(norms=norms, **{n: _norm_params(getattr(block, n), S) for n in norms})
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


def _modulate(x: torch.Tensor, h: torch.Tensor, p: Params) -> torch.Tensor:
    """γ‖β conv over the norm's hidden map ``h``, then the modulated
    instance norm, with γ and β read in place as the conv output's two
    channel halves."""
    gb = _cl(F.conv2d(_cl(h), p["mlp_gb"]["weight"], p["mlp_gb"]["bias"], padding=1))
    C = gb.shape[1] // 2
    return mat_norm_nchw(x, gb[:, :C], gb[:, C:])


def _mat_norm_fast(x: torch.Tensor, e: torch.Tensor, image_feat: torch.Tensor,
                   p: Params) -> torch.Tensor:
    """MATNorm with the shared conv split: state half by the constant-map
    shortcut, image half as a real conv."""
    h = F.conv2d(image_feat, p["k_img"], padding=1)
    h = _add_const_map(h, _reduce_terms(e, p["cmap_terms"]), p["mlp_shared_bias"])
    return _modulate(x, h.relu_(), p)


def _block_hidden_maps(image_feat: torch.Tensor, t_blk: torch.Tensor, p: Params,
                       norms: List[str]) -> List[torch.Tensor]:
    """All of a block's hidden maps in one pass: ONE conv over
    ``image_feat`` plus the pre-reduced state terms ``t_blk``, split back
    per norm."""
    sc = p["shared_cat"]
    h = _add_const_map(F.conv2d(image_feat, sc["weight"], padding=1), t_blk, sc["bias"]).relu_()
    widths = [p[n]["mlp_shared_bias"].shape[0] for n in norms]
    return list(torch.split(h, widths, dim=1))


def _res_block_fast(x: torch.Tensor, e: torch.Tensor, image_feat: torch.Tensor,
                    block: torch.nn.Module, p: Params,
                    t_blk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``MATResBlock.forward`` with the fast MAT norms; ``block`` supplies
    the res-block convs, ``p`` the block's fused operands."""
    norms = p["norms"]
    if t_blk is not None and "shared_cat" in p:
        hmaps = dict(zip(norms, _block_hidden_maps(image_feat, t_blk, p, norms)))
        mat_norm = lambda x, n: _modulate(x, hmaps[n], p[n])
    else:
        mat_norm = lambda x, n: _mat_norm_fast(x, e, image_feat, p[n])
    h = block.conv_0(F.leaky_relu(mat_norm(x, "norm_0"), 0.2))
    h = block.conv_1(F.leaky_relu(mat_norm(h, "norm_1"), 0.2))
    s = block.conv_s(mat_norm(x, "norm_s")) if "norm_s" in p else x
    return s + h


@torch.no_grad()
def fast_apply(gen: S2PGenerator, params: Params, state: torch.Tensor,
               prev_image: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``gen(state, prev_image)`` (mat_mode 'mat' only), NHWC
    in and out, with ``params = fuse_fast_params(gen, ...)``: the same
    weights, the same output up to float re-association. The encoder, the
    state embedding, the seed map, the res-block convs and the head are
    ``gen``'s own layers; only the MAT norms take the shortcut."""
    sizes = gen.sizes
    enc_by_size = {f.shape[-1]: f for f in gen.img_enc(prev_image.permute(0, 3, 1, 2))}
    e = gen.embed_state(state)
    x = gen.seed_map(e)

    # the whole network's state-side reduction in ONE matmul, sliced per block
    t_all = _reduce_terms(e, params["cmap_terms_all"]) if "cmap_terms_all" in params else None
    off = 0
    for i, size in enumerate(sizes):
        blk = params["blocks"][i]
        t_blk = None
        if t_all is not None and "shared_cat" in blk:
            w = blk["shared_cat"]["weight"].shape[0]
            t_blk = t_all[:, :, off:off + w]
            off += w
        x = _res_block_fast(x, e, enc_by_size[size], getattr(gen, f"block_{i}"), blk, t_blk)
        if i < len(sizes) - 1:
            x = upsample_nearest(x, sizes[i + 1])
    x = gen.conv_img(F.leaky_relu(x, 0.2))
    return torch.tanh(x).permute(0, 2, 3, 1)


@torch.no_grad()
def generate_rollout_fast(gen: S2PGenerator, init_image: torch.Tensor,
                          states: torch.Tensor, block_fusion: bool = True) -> torch.Tensor:
    """``seq_len`` autoregressive steps with ``fast_apply``: init_image
    ``[B, H, W, C]``, states ``[T, B, S]`` (s_{t+1} for each step) →
    frames ``[T, B, H, W, C]``. The weights are fused once, before the
    loop; ``block_fusion`` toggles the block-level fusion (see
    ``fuse_fast_params``)."""
    params = fuse_fast_params(gen, block_level=block_fusion)
    frames = []
    img = init_image
    for s in states:
        img = fast_apply(gen, params, s, img)
        frames.append(img)
    return torch.stack(frames)
