"""BEAR/BCQ-style VAE behaviour policy and ``PolicyFromQ``: the port of
``s2p_tpu/rl/vae_policy.py``.

- ``VAEPolicy`` (rlkit's ``sac/policies/vae_policy.py``): a CVAE over
  (state, action), encoder (750, 750) → (μ, log σ clamped to [−4, 15]),
  decoder (750, 750) → the tanh'd action times ``max_action``; ``decode``
  with z = clip(0.5·ε, ±0.5) when no latent is given; ``decode_multiple``
  for the BEAR MMD penalty. Module names are flax's (``e1, e2, mean,
  log_std, d1, d2, d3``); kernels are flax's default (LeCun normal) and
  biases zero, from a CPU generator seeded from ``seed``. Each standard
  normal is given (``eps``) or drawn from a ``torch.Generator``.
- ``elbo_loss``: reconstruction MSE + β·KL(N(μ, σ) ‖ N(0, I)).
- ``PolicyFromQ`` (rlkit's ``policy_from_q.py``): acts with the argmax-Q of
  N proposals from a base policy.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.nn.convert import state_dict_from_jax_dense_tree
from s2p_tpu_torch.nn.distributions import _eps
from s2p_tpu_torch.nn.initializers import lecun_normal_
from s2p_tpu_torch.nn.mlp import init_generator


class VAEPolicy(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, latent_dim: int, hidden: int = 750,
                 max_action: float = 1.0, gen: Optional[torch.Generator] = None,
                 seed: int = 0) -> None:
        super().__init__()
        gen = init_generator(gen, seed)
        self.latent_dim, self.max_action = latent_dim, max_action
        shapes = dict(e1=(obs_dim + action_dim, hidden), e2=(hidden, hidden),
                      mean=(hidden, latent_dim), log_std=(hidden, latent_dim),
                      d1=(obs_dim + latent_dim, hidden), d2=(hidden, hidden),
                      d3=(hidden, action_dim))
        for name, (n_in, n_out) in shapes.items():
            fc = nn.Linear(n_in, n_out)
            lecun_normal_(fc.weight, gen)
            nn.init.zeros_(fc.bias)
            self.add_module(name, fc)

    def forward(self, state: torch.Tensor, action: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(reconstruction, mean, std), the BEAR training triple; z = μ + σ·ε."""
        h = F.relu(self.e1(torch.cat([state, action], dim=1)))
        h = F.relu(self.e2(h))
        mean = self.mean(h)
        std = torch.exp(self.log_std(h).clamp(-4.0, 15.0))
        z = mean + std * _eps(std.shape, std, generator, eps)
        return self.decode(state, z), mean, std

    def _decoder(self, x: torch.Tensor) -> torch.Tensor:
        return self.d3(F.relu(self.d2(F.relu(self.d1(x)))))

    def decode(self, state: torch.Tensor, z: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        if z is None:
            z = (0.5 * _eps((state.shape[0], self.latent_dim), state, generator, eps)
                 ).clamp(-0.5, 0.5)
        return self.max_action * torch.tanh(self._decoder(torch.cat([state, z], dim=1)))

    def decode_multiple(self, state: torch.Tensor, num_decode: int = 10,
                        generator: Optional[torch.Generator] = None,
                        eps: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tanh'd actions, raw actions), [B, num_decode, A]: ``num_decode``
        latents per state."""
        B = state.shape[0]
        z = (0.5 * _eps((B, num_decode, self.latent_dim), state, generator, eps)
             ).clamp(-0.5, 0.5)
        tiled = state[:, None].expand(B, num_decode, state.shape[1])
        raw = self._decoder(torch.cat([tiled, z], dim=-1))
        return self.max_action * torch.tanh(raw), raw


def elbo_loss(model: VAEPolicy, state: torch.Tensor, action: torch.Tensor,
              generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None,
              kl_weight: float = 0.5) -> torch.Tensor:
    """Reconstruction MSE + ``kl_weight``·KL(N(μ, σ) ‖ N(0, I)) (BEAR/BCQ)."""
    recon, mean, std = model(state, action, generator, eps)
    recon_loss = ((recon - action) ** 2).mean()
    kl = -0.5 * (1 + 2 * torch.log(std) - mean ** 2 - std ** 2).mean()
    return recon_loss + kl_weight * kl


def state_dict_from_jax_vae_params(params: Mapping) -> dict:
    """A JAX ``VAEPolicy`` tree (``{"params": ...}``, numpy leaves) as the
    port's state dict."""
    return state_dict_from_jax_dense_tree(params)


class PolicyFromQ:
    """Sample ``num_samples`` proposals from ``policy``, act with the one of
    the largest ``qf(obs, action)``; proposals from a generator on the
    policy's device seeded from ``seed``."""

    def __init__(self, qf: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 policy: nn.Module, num_samples: int = 10, seed: int = 0) -> None:
        self.qf, self.policy, self.num_samples = qf, policy, num_samples
        self.device = next(policy.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def get_action(self, obs) -> Tuple[np.ndarray, dict]:
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)[None]
        tiled = x.expand(self.num_samples, x.shape[1])
        actions = self.policy(tiled).sample(self.generator)
        best = self.qf(tiled, actions).reshape(-1).argmax()
        return actions[best].cpu().numpy(), {}

    def reset(self) -> None:
        pass
