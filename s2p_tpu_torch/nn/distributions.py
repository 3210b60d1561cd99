"""Minimal distribution toolkit.

The port of ``s2p_tpu/nn/distributions.py``: ``Normal``, ``TanhNormal`` and
``Delta`` as plain classes over tensors. Samples are reparameterized
(gradients flow through ``loc`` and ``scale``); ``sample`` draws its
standard normals from an explicit ``torch.Generator`` or takes them as
``eps``.

``TanhNormal`` uses the stable tanh log-det-Jacobian ``log(1 − tanh(u)²) =
2(log 2 − u − softplus(−2u))``, not the reference's ``log(1 − a² + eps)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

LOG_2 = 0.6931471805599453


def _eps(shape, like: torch.Tensor, generator: Optional[torch.Generator],
         eps: Optional[torch.Tensor]) -> torch.Tensor:
    if eps is not None:
        return eps
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


class Normal:
    """Diagonal Gaussian over the last axis."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor) -> None:
        self.loc, self.scale = loc, scale

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        return self.loc + self.scale * _eps(shape, self.loc, generator, eps)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """Elementwise log-density (summed over the event at the call site)."""
        var = self.scale.square()
        return (-0.5 * (value - self.loc).square() / var - torch.log(self.scale)
                - 0.5 * math.log(2.0 * math.pi))

    def entropy(self) -> torch.Tensor:
        return 0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(self.scale)

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def stddev(self) -> torch.Tensor:
        return self.scale.expand(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    def kl_divergence(self, other: "Normal") -> torch.Tensor:
        """KL(self ‖ other), elementwise."""
        var_ratio = (self.scale / other.scale).square()
        t1 = ((self.loc - other.loc) / other.scale).square()
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def stable_tanh_log_det_jacobian(pre_tanh: torch.Tensor) -> torch.Tensor:
    """log|d tanh(u)/du| = log(1 − tanh(u)²), computed stably."""
    return 2.0 * (LOG_2 - pre_tanh - F.softplus(-2.0 * pre_tanh))


class TanhNormal:
    """tanh(Normal(loc, scale)): the SAC/IQL/CQL policy head."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor) -> None:
        self.loc, self.scale = loc, scale

    @property
    def base(self) -> Normal:
        return Normal(self.loc, self.scale)

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.tanh(self.base.sample(generator, eps=eps))

    def sample_with_pre_tanh(self, generator: Optional[torch.Generator] = None,
                             eps: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        u = self.base.sample(generator, eps=eps)
        return torch.tanh(u), u

    def sample_and_log_prob(self, generator: Optional[torch.Generator] = None,
                            eps: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(action, log π(action) summed over the last axis)."""
        a, u = self.sample_with_pre_tanh(generator, eps)
        return a, self.log_prob(a, pre_tanh_value=u)

    def log_prob(self, value: torch.Tensor,
                 pre_tanh_value: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pre_tanh_value is None:
            # the open interval before atanh, so ±1 actions stay finite
            pre_tanh_value = torch.atanh(value.clamp(-1.0 + 1e-6, 1.0 - 1e-6))
        elementwise = (self.base.log_prob(pre_tanh_value)
                       - stable_tanh_log_det_jacobian(pre_tanh_value))
        return elementwise.sum(dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        return torch.tanh(self.loc)

    @property
    def mean(self) -> torch.Tensor:  # the deterministic eval action
        return torch.tanh(self.loc)


class Delta:
    """A deterministic distribution."""

    def __init__(self, value: torch.Tensor) -> None:
        self.value = value

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.value

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        hit = (value == self.value).all(dim=-1)
        return torch.where(hit, 0.0, -math.inf).to(self.value.dtype)

    @property
    def mode(self) -> torch.Tensor:
        return self.value

    @property
    def mean(self) -> torch.Tensor:
        return self.value
