"""SLAC's online actor-critic networks.

The port of ``s2p_tpu/slac/networks.py``:

- ``SlacGaussianPolicy``: one ReLU MLP over the feature_action window →
  (mean, log std clamped to [−20, 2]); ``forward`` is the deterministic
  action tanh(mean), ``sample`` a tanh-reparameterized action with its
  corrected log π as a column;
- ``TwinnedQNetwork``: two ReLU MLPs over ``[action ‖ z]`` (action first).

Dense names are flax's (``fc0..fcN``; ``net{1,2}_fc{i}``, ``net{1,2}_out``),
kernels Xavier-uniform and biases zero, from a CPU generator of ``seed``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict, state_dict_from_jax_dense_tree
from s2p_tpu_torch.nn.distributions import TanhNormal
from s2p_tpu_torch.nn.initializers import xavier_uniform_
from s2p_tpu_torch.nn.mlp import init_generator


def _dense(n_in: int, n_out: int, gen: torch.Generator) -> nn.Linear:
    fc = nn.Linear(n_in, n_out)
    xavier_uniform_(fc.weight, gen)
    nn.init.zeros_(fc.bias)
    return fc


class SlacGaussianPolicy(nn.Module):
    def __init__(self, input_dim: int, action_dim: int, hidden_units: Sequence[int] = (256, 256),
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        gen = init_generator(gen, seed)
        self.action_dim, self.n_layers = action_dim, len(hidden_units) + 1
        prev = input_dim
        for i, u in enumerate(hidden_units):
            self.add_module(f"fc{i}", _dense(prev, u, gen))
            prev = u
        self.add_module(f"fc{len(hidden_units)}", _dense(prev, 2 * action_dim, gen))

    def _net(self, feature_action: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = feature_action
        for i in range(self.n_layers - 1):
            h = F.relu(getattr(self, f"fc{i}")(h))
        mean, log_std = getattr(self, f"fc{self.n_layers - 1}")(h).chunk(2, dim=-1)
        return mean, log_std.clamp(-20.0, 2.0)

    def forward(self, feature_action: torch.Tensor) -> torch.Tensor:
        """The deterministic action tanh(mean)."""
        return torch.tanh(self._net(feature_action)[0])

    def dist(self, feature_action: torch.Tensor) -> TanhNormal:
        mean, log_std = self._net(feature_action)
        return TanhNormal(mean, torch.exp(log_std))

    def sample(self, feature_action: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(action, log π [B, 1]); the standard normals from ``generator``
        or ``eps``."""
        action, log_pi = self.dist(feature_action).sample_and_log_prob(generator, eps)
        return action, log_pi[:, None]


class TwinnedQNetwork(nn.Module):
    def __init__(self, z_dim: int, action_dim: int, hidden_units: Sequence[int] = (256, 256),
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        gen = init_generator(gen, seed)
        self.n_hidden = len(hidden_units)
        for name in ("net1", "net2"):
            prev = action_dim + z_dim
            for i, u in enumerate(hidden_units):
                self.add_module(f"{name}_fc{i}", _dense(prev, u, gen))
                prev = u
            self.add_module(f"{name}_out", _dense(prev, 1, gen))

    def _tower(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"{name}_fc{i}")(x))
        return getattr(self, f"{name}_out")(x)

    def forward(self, z: torch.Tensor, action: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([action, z], dim=-1)
        return self._tower("net1", x), self._tower("net2", x)


# a JAX SlacGaussianPolicy or TwinnedQNetwork tree (numpy leaves) ↔ the
# port's state dict: the dense-tree converters, since the names are flax's
state_dict_from_jax_slac_network_params = state_dict_from_jax_dense_tree
jax_slac_network_params_from_state_dict = jax_dense_tree_from_state_dict
