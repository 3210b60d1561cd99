"""Q/V critic networks.

The port of ``s2p_tpu/rl/critics.py``: ``Qfunction``/``Vfunction`` are
Mlps over (pre-encoded) features; ``CriticSLAC`` holds qf1, qf2 and vf, so
one Adam over its parameters is the reference's fused critic optimizer.
Target networks are a copy of the qf1/qf2 modules (``q_subtree``), moved
toward the online ones by ``soft_update`` with the JAX package's formula
``(1 − τ)·target + τ·online``.
"""

from __future__ import annotations

import copy
from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict, state_dict_from_jax_dense_tree
from s2p_tpu_torch.nn.mlp import ConcatMlp, Mlp, init_generator


class Qfunction(ConcatMlp):
    """Q(features, action): the inputs concatenated in that order."""


class Vfunction(Mlp):
    """V(features)."""


class CriticSLAC(nn.Module):
    """qf1, qf2 and vf over z: ``forward(z, a)`` → (q1, q2, vf);
    ``q_values(z, a)`` → (q1, q2); ``value(z)`` → vf."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int] = (1024, 1024),
                 hidden_activation: Callable = F.relu,
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        gen = init_generator(gen, seed)
        kw = dict(hidden_sizes=hidden_sizes, output_size=1, hidden_activation=hidden_activation,
                  gen=gen)
        self.qf1 = Qfunction(obs_dim + action_dim, **kw)
        self.qf2 = Qfunction(obs_dim + action_dim, **kw)
        self.vf = Vfunction(obs_dim, **kw)

    def forward(self, z: torch.Tensor, action: torch.Tensor):
        return self.qf1(z, action), self.qf2(z, action), self.vf(z)

    def q_values(self, z: torch.Tensor, action: torch.Tensor):
        return self.qf1(z, action), self.qf2(z, action)

    def value(self, z: torch.Tensor) -> torch.Tensor:
        return self.vf(z)


def q_subtree(critic: CriticSLAC) -> nn.ModuleDict:
    """Target networks: a frozen copy of the critic's qf1 and qf2."""
    targets = nn.ModuleDict(dict(qf1=copy.deepcopy(critic.qf1), qf2=copy.deepcopy(critic.qf2)))
    return targets.requires_grad_(False)


@torch.no_grad()
def soft_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """target ← (1 − τ)·target + τ·online, over the two modules' parameters
    in order."""
    t = list(target.parameters())
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, torch._foreach_mul(list(online.parameters()), tau))


def state_dict_from_jax_critic_params(params: Mapping) -> dict:
    """A JAX ``CriticSLAC`` tree (``{"params": {"qf1", "qf2", "vf"}}``) or a
    target-q tree (``{"qf1", "qf2"}``) as the port's state dict."""
    return state_dict_from_jax_dense_tree(params)


def jax_critic_params_from_state_dict(sd: Mapping) -> dict:
    return jax_dense_tree_from_state_dict(sd)
