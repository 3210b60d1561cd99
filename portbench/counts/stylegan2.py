"""FLOPs of StyleGAN2's generator and launches, bytes and FLOPs of its
demodulating epilogue launches, counted from a configuration's ``G``.

Model FLOPs: two a multiply-accumulate of every dense layer and
convolution of the reference (``reference/stylegan2.py``), as
``torch.utils.flop_counter.FlopCounterMode`` counts them there: the
mapping and the 26 style affines as GEMMs; each modulated 3×3 conv over
its output pixels and taps; each up-conv as the transposed conv it is,
over its input pixels and 3×3 taps; the FIR after it and the RGB
upsample's as depthwise 4×4 convs over their output pixels; each toRGB as
a 1×1 conv. The per-image weights and the demodulation are elementwise
and uncounted (the fast path's d is one small batched GEMM a pass).
``tests/test_torch_stylegan2.py`` holds the count to the flop counter.

The epilogue (``style_epilogue_demod_kernel``), one launch a conv layer
over its ``[B, r, r, C]`` output, in one of three modes (``epilogue_shapes``):
``fir`` (an up layer: the transposed conv's ``[B, r + 1, r + 1, C]`` output
read, the FIR taken in registers, t·s_next written), ``rgb`` (a layer that
feeds toRGB and the next conv: x read, t·s_next written in place, the toRGB
added into the RGB sum) or ``last`` (the last layer: x read, only the RGB sum
written). Bytes count each map read or written once, the float32 noise value
of each pixel, strength and bias (``2·C`` values), d and the next conv's
style (``B·C`` float32 values each), and with toRGB its per-image weights
(``B·C·3`` float32), the new RGB sum (12 bytes a pixel) and the previous one
(12 bytes a pixel of the resolution below). FLOPs per element 6 (x·d,
noise·strength + x, + bias, the slope, the gain), 1 more with the next
conv's style, 32 with the FIR (16 taps) and 6 with toRGB (3 outputs).
"""

from __future__ import annotations

import math
from typing import List, Tuple

from portbench import peaks
from portbench.reference import stylegan2 as ref

DEMOD_KERNEL = "style_epilogue_demod_kernel"
FIR_TAPS = 16  # the 4×4 FIR
FLOPS_PER_ELEMENT = 6
NOISE_ITEMSIZE = 4  # the noise maps and d, s are float32
F32_ITEMSIZE = 4
RGB = 3


def parameters(G) -> int:
    """The generator's trainable parameters (``dlatent_avg`` is a statistic)."""
    return sum(math.prod(shape) for shape, _ in ref.param_spec(G).values())


def generator_forward(G, batch: int) -> int:
    """FLOPs of one pass of ``batch`` frames."""
    L, D = G["mapping_layers"], G["dlatent_size"]
    total = 0
    for i in range(L):
        c_in = G["latent_size"] if i == 0 else G["mapping_fmaps"]
        c_out = D if i == L - 1 else G["mapping_fmaps"]
        total += 2 * batch * c_in * c_out
    for _, kind, res, c_in, c_out, _ in ref.layers(G):
        total += 2 * batch * D * c_in  # the style affine
        if kind == "conv":
            total += 2 * batch * res * res * c_in * c_out * 9
        elif kind == "up":  # the transposed conv over its input pixels, then the FIR
            total += 2 * batch * (res // 2) ** 2 * c_in * c_out * 9
            total += 2 * batch * res * res * c_out * FIR_TAPS
        else:  # toRGB, and the upsample of the RGB sum below it
            total += 2 * batch * res * res * c_in * c_out
            if res > 4:
                total += 2 * batch * res * res * c_out * FIR_TAPS
    return total


def epilogue_shapes(G) -> List[Tuple[int, int, str]]:
    """(r, C, mode) of each conv layer's epilogue in layer order."""
    convs = ref.conv_layers(G)
    return [(res, c_out, "fir" if kind == "up" else "last" if i == len(convs) - 1 else "rgb")
            for i, (_, kind, res, _, c_out, _) in enumerate(convs)]


def launches(G) -> int:
    return len(epilogue_shapes(G))


def epilogue_bytes(batch: int, res: int, channels: int, itemsize: int, mode: str) -> int:
    """A demodulating epilogue launch's bytes."""
    pixels = batch * res * res
    maps = {"fir": batch * (res + 1) ** 2 + pixels, "rgb": 2 * pixels, "last": pixels}[mode]
    rows = (1 if mode == "last" else 2) * batch * channels * F32_ITEMSIZE  # d, s_next
    total = (maps * channels + 2 * channels) * itemsize + pixels * NOISE_ITEMSIZE + rows
    if mode != "fir":  # the toRGB weights, the new RGB sum and the previous one
        prev = batch * (res // 2) ** 2 if res > 4 else 0
        total += (batch * channels + pixels + prev) * RGB * F32_ITEMSIZE
    return total


def epilogue_flops(batch: int, res: int, channels: int, mode: str) -> int:
    """A demodulating epilogue launch's FLOPs."""
    per = FLOPS_PER_ELEMENT + (mode != "last") + {"fir": 2 * FIR_TAPS}.get(mode, 2 * RGB)
    return per * batch * res * res * channels


def epilogue_bound_s(G, batch: int, itemsize: int) -> float:
    """The least time of one pass's epilogue launches: per launch the larger
    of bytes at the HBM rate and FLOPs at the f32 rate."""
    return sum(max(epilogue_bytes(batch, res, c, itemsize, mode) / peaks.HBM_BYTES,
                   epilogue_flops(batch, res, c, mode) / peaks.F32_FLOPS)
               for res, c, mode in epilogue_shapes(G))
