"""FLOPs of GauGAN's generator and launches, bytes and FLOPs of the SPADE-norm
kernel, counted from a configuration's ``opt``.

Model FLOPs: two a multiply-accumulate of every convolution (all taps, padding
included), as the reference defines the model, whatever path computes it
(the fast path pads the one-hot map's channels to a multiple of 8 with zeros;
those are not the model's). ``tests/test_torch_spade.py`` holds the count to
``torch.utils.flop_counter.FlopCounterMode`` over the reference.

The kernel (``spade_norm_kernel``): one launch per SPADE norm with batch
statistics, over one ``[B, H, W, C]`` activation. Bytes count x, γ and β read
once and out written once (4 arrays; the f32 ``[C]`` statistics are left
out); FLOPs per element 5: x·a + b (2), 1 + γ, the product, + β.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench import peaks
from portbench.reference import spade

KERNEL = "spade_norm_kernel"
ARRAYS = 4
FLOPS_PER_ELEMENT = 5


def conv(batch: int, c_in: int, c_out: int, k: int, hw: Tuple[int, int]) -> int:
    return 2 * batch * c_out * hw[0] * hw[1] * c_in * k * k


def generator_forward(opt, batch: int) -> int:
    snc, nh = spade.semantic_nc(opt), opt["nhidden"]
    total = conv(batch, snc, 16 * opt["ngf"], 3, spade.latent_hw(opt))
    for (_, fin, fout, _), hw in zip(spade.schedule(opt), spade.block_sizes(opt)):
        for _, width in spade.block_norms(fin, fout):
            total += conv(batch, snc, nh, 3, hw) + 2 * conv(batch, nh, width, 3, hw)
        fmid = min(fin, fout)
        total += conv(batch, fin, fmid, 3, hw) + conv(batch, fmid, fout, 3, hw)
        if fin != fout:
            total += conv(batch, fin, fout, 1, hw)
    final = spade.schedule(opt)[-1][2]
    return total + conv(batch, final, 3, 3, spade.block_sizes(opt)[-1])


def norm_shapes(opt) -> Dict[Tuple[int, int, int], int]:
    """(H, W, C) → SPADE-norm launches per generator pass (none for instance
    norm, which runs the MAT-norm kernel)."""
    shapes: Dict[Tuple[int, int, int], int] = {}
    if spade.param_free_kind(opt) != "batch":
        return shapes
    for (_, fin, fout, _), (h, w) in zip(spade.schedule(opt), spade.block_sizes(opt)):
        for _, c in spade.block_norms(fin, fout):
            shapes[(h, w, c)] = shapes.get((h, w, c), 0) + 1
    return shapes


def launches(opt) -> int:
    return sum(norm_shapes(opt).values())


def bound_s(opt, batch: int, itemsize: int) -> float:
    """The least time of one pass's launches: per launch the larger of bytes
    at the HBM rate and FLOPs at the f32 rate."""
    total = 0.0
    for (h, w, c), n in norm_shapes(opt).items():
        elems = batch * h * w * c
        total += n * max(ARRAYS * elems * itemsize / peaks.HBM_BYTES,
                         FLOPS_PER_ELEMENT * elems / peaks.F32_FLOPS)
    return total
