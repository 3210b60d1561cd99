"""Weight initializers matching the reference's conventions.

The port of ``s2p_tpu/nn/initializers.py``. Each function fills a torch
parameter in place from an explicit ``torch.Generator`` (on the CPU, so a
seed gives the same weights on every device). A torch ``Linear`` weight is
``(out, in)`` and a conv weight ``(out, in, kh, kw)`` where flax stores
``(in, out)`` and ``(kh, kw, in, out)``: the fan-in is the product of the
torch shape past its first axis in both.

- ``fanin_uniform_``: U(−1/√fan_in, 1/√fan_in), the rlkit MLP default.
- ``xavier_uniform_``: SLAC's Glorot-uniform kernels.
- ``uniform_``: U(−bound, bound), the rlkit last-layer init.
- ``uniform_bias``: the constant-fill bias init.
- ``lecun_normal_``: flax's default kernel init (truncated normal).
- ``scaled_orthogonal_``: an orthogonal matrix times a gain, SLAC's
  initializer (rlkit's ``slac/network/initializer.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def fan_in(weight: torch.Tensor) -> int:
    """Inputs per output unit of a torch ``Linear`` or conv weight."""
    return weight[0].numel()


@torch.no_grad()
def fanin_uniform_(weight: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in(weight))
    return weight.copy_(torch.empty(weight.shape).uniform_(-bound, bound, generator=gen))


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> torch.Tensor:
    return t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=gen))


@torch.no_grad()
def xavier_uniform_(weight: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Glorot uniform; symmetric in fan-in and fan-out, so a transposed
    conv's ``(in, out, k, k)`` weight gets flax's bound too."""
    return weight.copy_(nn.init.xavier_uniform_(torch.empty(weight.shape), generator=gen))


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, gen: torch.Generator, fan: int | None = None
                  ) -> torch.Tensor:
    """Truncated normal (±2σ) with variance 1/fan_in after truncation."""
    std = math.sqrt(1.0 / (fan or fan_in(weight))) / 0.87962566103423978
    return weight.copy_(nn.init.trunc_normal_(torch.empty(weight.shape), std=std, a=-2 * std,
                                              b=2 * std, generator=gen))


@torch.no_grad()
def scaled_orthogonal_(weight: torch.Tensor, gen: torch.Generator,
                       gain: float = 1.41421356) -> torch.Tensor:
    """Orthonormal rows (or columns, when there are fewer of them) of the
    weight flattened past its first axis, times ``gain`` (√2, SLAC's
    default)."""
    return weight.copy_(nn.init.orthogonal_(torch.empty(weight.shape), gain=gain, generator=gen))


@torch.no_grad()
def uniform_bias(bias: torch.Tensor, value: float = 0.1) -> torch.Tensor:
    """rlkit's ``b_init_value``: a constant fill."""
    return bias.fill_(value)
