"""Launches, bytes and FLOPs of the fused MAT-norm kernels, from the shapes.

A launch normalises one [B, H, W, C] activation. Bytes count each input
read once and each output written once: the forward reads x, γ and β and
writes out (4 arrays); the backward reads dy, x and γ and writes dx and dγ
(5 arrays); the f32 statistics ([B, C]) are left out. FLOPs per element:
forward 9 (sum 1; centred square sum 3; normalise 2; ·(1 + γ) + β 3),
backward 12 (x̂ 2; g = dy·(1 + γ) 2; mean g 1; Σ g·x̂ 2; dx 4; dγ 1).
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench import peaks
from portbench.reference import nets

ARRAYS = {"forward": 4, "backward": 5}
FLOPS_PER_ELEMENT = {"forward": 9, "backward": 12}
KERNEL = {"forward": "fused_mat_norm_kernel", "backward": "fused_mat_norm_bwd_kernel"}


def norm_shapes(cfg) -> Dict[Tuple[int, int], int]:
    """(H, C) → launches per generator forward: norm_0 on the block input,
    norm_1 on min(in, out), norm_s on the input where the width changes."""
    shapes: Dict[Tuple[int, int], int] = {}
    for size, (c_in, c_out) in zip(nets.sizes(cfg), nets.block_channels(cfg)):
        for _, c in nets.block_norms(c_in, c_out):
            shapes[(size, c)] = shapes.get((size, c), 0) + 1
    return shapes


def launches(cfg) -> int:
    return sum(norm_shapes(cfg).values())


def launch_bytes(direction: str, batch: int, size: int, channels: int, itemsize: int) -> int:
    return ARRAYS[direction] * batch * size * size * channels * itemsize


def bound_s(cfg, direction: str, batch: int, itemsize: int) -> float:
    """The least time of one generator pass's launches in ``direction``:
    per launch the larger of bytes at the HBM rate and FLOPs at the f32 rate."""
    total = 0.0
    for (size, c), n in norm_shapes(cfg).items():
        elems = batch * size * size * c
        total += n * max(launch_bytes(direction, batch, size, c, itemsize) / peaks.HBM_BYTES,
                         FLOPS_PER_ELEMENT[direction] * elems / peaks.F32_FLOPS)
    return total
