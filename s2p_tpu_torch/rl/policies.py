"""Policy networks.

The port of ``s2p_tpu/rl/policies.py``:

- ``TanhGaussianPolicy``: ReLU MLP trunk, a mean head and a
  state-dependent log-std head clamped to [−20, 2] (or a fixed std),
  returning a ``TanhNormal``;
- ``GaussianPolicy``: a tanh'd mean with a clamped log std (the 'shared'
  std architecture), returning a ``Normal``;
- ``make_deterministic``: the distribution's mode as a ``Delta``.

Layer names are flax's (``fc{i}``, ``last_fc``, ``last_fc_log_std``).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict, state_dict_from_jax_dense_tree
from s2p_tpu_torch.nn.distributions import Delta, Normal, TanhNormal
from s2p_tpu_torch.nn.initializers import fanin_uniform_, uniform_
from s2p_tpu_torch.nn.mlp import init_generator

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0


class _GaussianTrunk(nn.Module):
    def __init__(self, obs_dim: int, hidden_sizes: Sequence[int], action_dim: int,
                 std: Optional[float], init_w: float, hidden_activation: Callable,
                 uniform_bias: bool, gen: Optional[torch.Generator], seed: int):
        super().__init__()
        gen = init_generator(gen, seed)
        self.std, self.hidden_activation = std, hidden_activation
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.n_hidden = len(hidden_sizes)
        prev = obs_dim
        for i, size in enumerate(hidden_sizes):
            fc = nn.Linear(prev, size)
            fanin_uniform_(fc.weight, gen)
            nn.init.zeros_(fc.bias)
            self.add_module(f"fc{i}", fc)
            prev = size
        heads = ["last_fc"] + (["last_fc_log_std"] if std is None else [])
        for name in heads:
            fc = nn.Linear(prev, action_dim)
            uniform_(fc.weight, init_w, gen)
            if uniform_bias:
                uniform_(fc.bias, init_w, gen)
            else:
                nn.init.zeros_(fc.bias)
            self.add_module(name, fc)

    def trunk(self, obs: torch.Tensor) -> torch.Tensor:
        h = obs
        for i in range(self.n_hidden):
            h = self.hidden_activation(getattr(self, f"fc{i}")(h))
        return h


class TanhGaussianPolicy(_GaussianTrunk):
    def __init__(self, obs_dim: int, hidden_sizes: Sequence[int], action_dim: int,
                 std: Optional[float] = None, init_w: float = 1e-3,
                 hidden_activation: Callable = F.relu,
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__(obs_dim, hidden_sizes, action_dim, std, init_w, hidden_activation,
                         True, gen, seed)

    def forward(self, obs: torch.Tensor) -> TanhNormal:
        h = self.trunk(obs)
        mean = self.last_fc(h)
        if self.std is None:
            std = torch.exp(self.last_fc_log_std(h).clamp(LOG_SIG_MIN, LOG_SIG_MAX))
        else:
            std = torch.full_like(mean, self.std)
        return TanhNormal(mean, std)


class GaussianPolicy(_GaussianTrunk):
    def __init__(self, obs_dim: int, hidden_sizes: Sequence[int], action_dim: int,
                 std: Optional[float] = None, init_w: float = 1e-3, max_log_std: float = 0.0,
                 min_log_std: float = -6.0, hidden_activation: Callable = F.relu,
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__(obs_dim, hidden_sizes, action_dim, std, init_w, hidden_activation,
                         False, gen, seed)
        self.max_log_std, self.min_log_std = max_log_std, min_log_std

    def forward(self, obs: torch.Tensor) -> Normal:
        h = self.trunk(obs)
        mean = torch.tanh(self.last_fc(h))
        if self.std is None:
            log_std = self.last_fc_log_std(h).clamp(self.min_log_std, self.max_log_std)
            std = torch.exp(log_std)
        else:
            std = torch.full_like(mean, self.std)
        return Normal(mean, std)


def make_deterministic(dist) -> Delta:
    """The evaluation policy: the distribution's mode."""
    return Delta(dist.mode)


def state_dict_from_jax_policy_params(params: Mapping) -> dict:
    """A JAX policy tree (``{"params": ...}``, numpy leaves) as the port's
    state dict."""
    return state_dict_from_jax_dense_tree(params)


def jax_policy_params_from_state_dict(sd: Mapping) -> dict:
    return jax_dense_tree_from_state_dict(sd)
