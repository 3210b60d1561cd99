"""FLOPs of StyleGAN's generator and launches, bytes and FLOPs of its AdaIN
launches of the MAT-norm kernel, counted from a configuration's ``G``.

Model FLOPs: two a multiply-accumulate of every dense layer and
convolution of the reference (``reference/stylegan.py``), as
``torch.utils.flop_counter.FlopCounterMode`` counts them there: a
convolution over all its taps and output pixels (padding included), the
fused up-conv as a transposed conv over its input pixels and 4×4 taps, the
blur as a depthwise conv, the 18 style affines and the mapping as GEMMs.
``tests/test_torch_stylegan.py`` holds the count to the flop counter. The
fast path runs the nearest up-convs below 128² as transposed convs too
(fewer operations); the model's count stays the reference's.

The kernels, one launch each per synthesis layer over one ``[B, r, r, C]``
activation:
- AdaIN (``fused_mat_norm_kernel``): bytes count x read once and out
  written once, and γ and β as the ``2·B·C`` values they are (the kernel
  broadcasts them over the pixels; the f32 statistics are left out); FLOPs
  per element the MAT norm's 9 (``mat_norm.FLOPS_PER_ELEMENT``).
- the epilogue (``style_epilogue_kernel``): x read and written once, the
  float32 noise value of each pixel read once, strength and bias ``2·C``
  values; FLOPs per element 4 (noise × strength, + x, + bias, the slope).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from portbench import peaks
from portbench.counts import mat_norm
from portbench.reference import stylegan as ref

KERNEL = mat_norm.KERNEL["forward"]
EPILOGUE_KERNEL = "style_epilogue_kernel"
EPILOGUE_FLOPS_PER_ELEMENT = 4
NOISE_ITEMSIZE = 4  # the noise maps are float32


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
    for _, kind, res, c_in, c_out in ref.layers(G):
        total += 2 * batch * D * 2 * c_out  # the style affine
        if kind == "conv":
            total += 2 * batch * res * res * c_in * c_out * 9
        elif kind == "up":
            if ref.fused(res):  # the transposed conv: each input pixel × 16 taps
                total += 2 * batch * (res // 2) ** 2 * c_in * c_out * 16
            else:
                total += 2 * batch * res * res * c_in * c_out * 9
            total += 2 * batch * res * res * c_out * 9  # the blur, depthwise 3×3
    c_last = ref.nf(G, ref.log2_res(G) - 1)
    return total + 2 * batch * G["resolution"] ** 2 * c_last * G["num_channels"]


def norm_shapes(G) -> Dict[Tuple[int, int], int]:
    """(r, C) → AdaIN launches per pass."""
    shapes: Dict[Tuple[int, int], int] = {}
    for _, _, res, _, c in ref.layers(G):
        shapes[(res, c)] = shapes.get((res, c), 0) + 1
    return shapes


def launches(G) -> int:
    return sum(norm_shapes(G).values())


def launch_bytes(batch: int, res: int, channels: int, itemsize: int) -> int:
    """An AdaIN launch's bytes."""
    return (2 * batch * res * res * channels + 2 * batch * channels) * itemsize


def epilogue_bytes(batch: int, res: int, channels: int, itemsize: int) -> int:
    """An epilogue launch's bytes."""
    return ((2 * batch * res * res * channels + 2 * channels) * itemsize
            + batch * res * res * NOISE_ITEMSIZE)


def _pass_bound(G, batch: int, itemsize: int, nbytes, flops_per_element: int) -> float:
    total = 0.0
    for (res, c), n in norm_shapes(G).items():
        elems = batch * res * res * c
        total += n * max(nbytes(batch, res, c, itemsize) / peaks.HBM_BYTES,
                         flops_per_element * elems / peaks.F32_FLOPS)
    return total


def bound_s(G, batch: int, itemsize: int) -> float:
    """The least time of one pass's AdaIN launches: per launch the larger of
    bytes at the HBM rate and FLOPs at the f32 rate."""
    return _pass_bound(G, batch, itemsize, launch_bytes, mat_norm.FLOPS_PER_ELEMENT["forward"])


def epilogue_bound_s(G, batch: int, itemsize: int) -> float:
    """The same for one pass's epilogue launches."""
    return _pass_bound(G, batch, itemsize, epilogue_bytes, EPILOGUE_FLOPS_PER_ELEMENT)
