"""Policy adapters and the SLAC observation window: the port of
``s2p_tpu/samplers/agents.py``.

- ``SlacObservation`` (the reference's ``slac/trainer.py``): a
  ``num_sequences``-frame, (``num_sequences`` − 1)-action sliding window,
  reset with zeros or with the first observation repeated.
- ``PolicyAgent``: the ``get_action`` adapter the samplers call, over a
  torch policy module on its device, without gradients. Deterministic mode
  acts with the distribution's mode and draws nothing; stochastic mode
  samples from a ``torch.Generator`` on the module's device seeded from
  ``seed``. The agent acts with the module's current weights, so an agent
  built on a trainer's policy follows its updates; ``set_params`` loads a
  state dict of the port or a JAX ``params`` tree of numpy leaves (a
  snapshot's ``policy_params``).
- ``RandomAgent``: uniform actions from the action space.
"""

from __future__ import annotations

from collections import deque
from collections.abc import Mapping
from typing import Any, Optional, Tuple

import numpy as np
import torch

from s2p_tpu_torch.rl.policies import state_dict_from_jax_policy_params


class SlacObservation:
    def __init__(self, state_shape, action_shape, num_sequences: int,
                 reset_w_same_obs: bool = False):
        self.state_shape = tuple(state_shape)
        self.action_shape = tuple(action_shape)
        self.num_sequences = num_sequences
        self.reset_w_same_obs = reset_w_same_obs

    def reset_episode(self, state: np.ndarray) -> None:
        self._state = deque(maxlen=self.num_sequences)
        self._action = deque(maxlen=self.num_sequences - 1)
        for _ in range(self.num_sequences - 1):
            if self.reset_w_same_obs:
                self._state.append(state.copy().astype(np.uint8))
            else:
                self._state.append(np.zeros(self.state_shape, np.uint8))
            self._action.append(np.zeros(self.action_shape, np.float32))
        self._state.append(state)

    def append(self, state: np.ndarray, action: np.ndarray) -> None:
        self._state.append(state)
        self._action.append(np.asarray(action, np.float32))

    @property
    def state(self) -> np.ndarray:
        return np.array(self._state)  # [num_seq, H, W, C]

    @property
    def action(self) -> np.ndarray:
        return np.array(self._action).reshape(-1)  # [(num_seq-1)*A]


class PolicyAgent:
    """``get_action`` over a torch policy module; deterministic = eval mode."""

    def __init__(self, module: torch.nn.Module, params: Optional[Mapping] = None,
                 deterministic: bool = False, seed: int = 0):
        self.module = module
        self.deterministic = deterministic
        self.device = next(module.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if params is not None:
            self.set_params(params)

    def set_params(self, params: Mapping) -> None:
        """Load a state dict of the port, or a JAX policy tree (``{"params":
        ...}`` or its inner dict, numpy leaves), into the module."""
        inner = params.get("params", params)
        if any(isinstance(v, Mapping) for v in inner.values()):
            params = state_dict_from_jax_policy_params(params)
        self.module.load_state_dict(params, strict=True)

    @torch.no_grad()
    def get_action(self, obs: Any) -> Tuple[np.ndarray, dict]:
        """The action for one observation (a host array, or a tensor that may
        already be on the module's device) as a host array."""
        dtype = next(self.module.parameters()).dtype
        x = torch.as_tensor(obs, device=self.device).to(dtype)
        dist = self.module(x[None])
        a = dist.mode if self.deterministic else dist.sample(self.generator)
        return a[0].cpu().numpy(), {}

    def reset(self) -> None:
        pass


class RandomAgent:
    """Uniform random policy (exploration stub / data collection)."""

    def __init__(self, action_space):
        self.action_space = action_space

    def get_action(self, obs) -> Tuple[np.ndarray, dict]:
        return self.action_space.sample(), {}

    def reset(self) -> None:
        pass
