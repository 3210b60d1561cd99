"""Additional env wrappers: the port of ``s2p_tpu/envs/extra_wrappers.py``
(plain numpy).

Capability contract (reference: rlkit/envs/wrappers.py — HistoryEnv,
DiscretizeEnv, RewardWrapperEnv, StackObservationEnv): observation history
concatenation, uniform action-space discretization, reward transformation,
and same-obs stacking. All keep the gym-classic 4-tuple API used by the
samplers."""

from __future__ import annotations

from collections import deque
from itertools import product
from typing import Callable, List

import numpy as np

from s2p_tpu_torch.envs.wrappers import Box, ProxyEnv


class HistoryEnv(ProxyEnv):
    """Concatenate the last ``history_len`` observations."""

    def __init__(self, env, history_len: int):
        super().__init__(env)
        self.history_len = history_len
        self.history: deque = deque(maxlen=history_len)
        dim = int(np.prod(env.observation_space.shape)) * history_len
        self.observation_space = Box(
            -np.inf, np.inf, shape=(dim,), dtype=np.float32
        )

    def reset(self, **kwargs):
        obs = self._wrapped_env.reset(**kwargs)
        self.history = deque(maxlen=self.history_len)
        for _ in range(self.history_len - 1):
            self.history.append(np.zeros_like(obs))
        self.history.append(obs)
        return self._get_obs()

    def step(self, action):
        obs, r, d, info = self._wrapped_env.step(action)
        self.history.append(obs)
        return self._get_obs(), r, d, info

    def _get_obs(self):
        return np.concatenate(list(self.history), axis=0)


class DiscretizeEnv(ProxyEnv):
    """Uniform grid over the Box action space; actions become indices."""

    def __init__(self, env, num_bins: int):
        super().__init__(env)
        low, high = env.action_space.low, env.action_space.high
        grids = [np.linspace(lo, hi, num_bins) for lo, hi in zip(low, high)]
        self.idx_to_continuous_action: List[np.ndarray] = [
            np.asarray(a, np.float32) for a in product(*grids)
        ]
        self.n = len(self.idx_to_continuous_action)

        class _Discrete:
            def __init__(self, n):
                self.n = n
                self.shape = ()

            def sample(self_inner):
                return np.random.randint(self_inner.n)

        self.action_space = _Discrete(self.n)

    def step(self, action):
        return self._wrapped_env.step(self.idx_to_continuous_action[int(action)])


class RewardWrapperEnv(ProxyEnv):
    """Apply ``compute_reward_fn(reward, info)`` per step."""

    def __init__(self, env, compute_reward_fn: Callable):
        super().__init__(env)
        self.compute_reward_fn = compute_reward_fn

    def step(self, action):
        obs, r, d, info = self._wrapped_env.step(action)
        return obs, self.compute_reward_fn(r, info), d, info


class StackObservationEnv(ProxyEnv):
    """Repeat the current observation ``stack_obs`` times (reference
    StackObservationEnv: obs space tiled, obs duplicated)."""

    def __init__(self, env, stack_obs: int = 1):
        super().__init__(env)
        self.stack_obs = stack_obs
        dim = int(np.prod(env.observation_space.shape))
        self.observation_space = Box(
            -np.inf, np.inf, shape=(dim * stack_obs,), dtype=np.float32
        )

    def reset(self, **kwargs):
        obs = self._wrapped_env.reset(**kwargs)
        return np.tile(obs, self.stack_obs)

    def step(self, action):
        obs, r, d, info = self._wrapped_env.step(action)
        return np.tile(obs, self.stack_obs), r, d, info
