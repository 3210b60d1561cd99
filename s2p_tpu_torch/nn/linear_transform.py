"""y = m·x + b, the reward/terminal transform: the port of
``s2p_tpu/nn/linear_transform.py`` (rlkit's ``linear_transform.py``; IQL
and CQL apply it to rewards and terminals at the top of a step)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LinearTransform:
    m: float = 1.0
    b: float = 0.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.m * x + self.b
