"""Gaussian mixture distributions: the port of ``s2p_tpu/nn/mixture.py``.

K diagonal Gaussians over the action dimension with per-sample weights
(rlkit's ``GaussianMixture``): ``log_prob`` is a logsumexp over the
components, ``mle_estimate`` the mean of the most likely component.
Layouts are the JAX package's: means and stds [B, D, K], weights [B, K].
``sample`` takes its standard normals (``eps``, [B, D, K]) and component
indices (``component``, [B]) as given, or draws them from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from s2p_tpu_torch.nn.distributions import Normal


def _pick(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[b, :, index[b]]`` for [B, D, K] ``x``."""
    return x.gather(-1, index[:, None, None].expand(*x.shape[:-1], 1))[..., 0]


@dataclasses.dataclass
class GaussianMixture:
    means: torch.Tensor  # [B, D, K]
    stds: torch.Tensor  # [B, D, K]
    weights: torch.Tensor  # [B, K], rows sum to 1

    @property
    def num_gaussians(self) -> int:
        return self.weights.shape[-1]

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """[B] mixture log-density: each component's log-density summed over
        the action dimension, logsumexp over the components."""
        comp = Normal(self.means.movedim(-1, 0), self.stds.movedim(-1, 0)).log_prob(value[None])
        lp = torch.log(self.weights.T + 1e-12) + comp.sum(-1)  # [K, B]
        return torch.logsumexp(lp, dim=0)

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None,
               component: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, D]: a draw of each component (from ``eps``), then one
        component per row with probability ∝ weight + 1e-12 (``component``)."""
        z = Normal(self.means, self.stds).sample(generator, eps)
        if component is None:
            component = torch.multinomial(self.weights + 1e-12, 1, generator=generator)[:, 0]
        return _pick(z, component)

    def mle_estimate(self) -> torch.Tensor:
        """The mean of the most likely component."""
        return _pick(self.means, self.weights.argmax(-1))

    @property
    def mode(self) -> torch.Tensor:
        return self.mle_estimate()

    @property
    def mean(self) -> torch.Tensor:
        return (self.means * self.weights[:, None, :]).sum(-1)
