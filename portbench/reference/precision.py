"""How the plain reference computes.

``f32``: float32 with TF32 off (the reference the port is judged by).
``bf16``: every tensor in bfloat16 (the control of a float32 cell).
``fp8``: the operands of every convolution and linear layer rounded to
float8 e4m3 with a per-tensor scale, everything else in bfloat16, as an
fp8 inference or training path computes (the control of a bfloat16 cell).
The rounding passes gradients straight through.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 value


class Precision:
    def __init__(self, name: str):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float32 if name == "f32" else torch.bfloat16

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.name != "fp8":
            return t
        scale = FP8_MAX / t.detach().float().abs().amax().clamp_min(1e-12)
        q = ((t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
        return t + (q - t).detach() if t.requires_grad else q

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.operand(x), self.operand(w), b, stride, padding)

    def linear(self, x, w, b=None):
        return F.linear(self.operand(x), self.operand(w), b)

    def cast(self, weights: dict) -> dict:
        return {k: v.to(self.dtype) for k, v in weights.items()}


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN and cuBLAS inside the block, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
