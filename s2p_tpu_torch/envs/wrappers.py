"""Environment wrappers and the stub env: the port of
``s2p_tpu/envs/wrappers.py`` (plain numpy).

- ``Box``: a minimal action/observation space (no gym dependency);
- ``NormalizedBoxEnv`` (rlkit's ``normalized_box_env.py``): actions from
  [−1, 1] to the env's bounds, optional observation normalisation and
  reward scale;
- ``StubEnv`` (rlkit's ``stub_classes.py``): zero dynamics, state or seeded
  uint8 image observations, so collectors and loops run without MuJoCo.

The env API is gym-classic: ``step`` returns a 4-tuple with
``TimeLimit.truncated`` in the info, which the rollout reads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Box:
    """Minimal Box space (avoids a hard gym dependency at the core layer)."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.low = np.broadcast_to(np.asarray(low, dtype), shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype), shape).copy()
        self.shape = tuple(shape)
        self.dtype = dtype
        self._rng = np.random.RandomState()

    def seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    def sample(self) -> np.ndarray:
        lo = np.where(np.isfinite(self.low), self.low, -1.0)
        hi = np.where(np.isfinite(self.high), self.high, 1.0)
        return self._rng.uniform(lo, hi).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and (x >= self.low - 1e-6).all() and (
            x <= self.high + 1e-6
        ).all()


class ProxyEnv:
    def __init__(self, wrapped_env):
        self._wrapped_env = wrapped_env
        self.action_space = wrapped_env.action_space
        self.observation_space = wrapped_env.observation_space

    def __getattr__(self, name):
        return getattr(self._wrapped_env, name)

    def reset(self, **kwargs):
        return self._wrapped_env.reset(**kwargs)

    def step(self, action):
        return self._wrapped_env.step(action)


class NormalizedBoxEnv(ProxyEnv):
    """Actions in [−1, 1] → env bounds; optional running-stat obs
    normalization and reward scaling (reference normalized_box_env.py:7-76)."""

    def __init__(
        self,
        env,
        reward_scale: float = 1.0,
        obs_mean: Optional[np.ndarray] = None,
        obs_std: Optional[np.ndarray] = None,
    ):
        super().__init__(env)
        self._should_normalize = obs_mean is not None or obs_std is not None
        self._obs_mean = obs_mean
        self._obs_std = obs_std
        self._reward_scale = reward_scale
        ub = np.ones(env.action_space.shape, np.float32)
        self.action_space = Box(-1.0 * ub, ub)

    def _apply_normalize_obs(self, obs):
        if not self._should_normalize:
            return obs
        mean = self._obs_mean if self._obs_mean is not None else 0.0
        std = self._obs_std if self._obs_std is not None else 1.0
        return (obs - mean) / (std + 1e-8)

    def reset(self, **kwargs):
        return self._apply_normalize_obs(self._wrapped_env.reset(**kwargs))

    def step(self, action):
        lb = self._wrapped_env.action_space.low
        ub = self._wrapped_env.action_space.high
        scaled = lb + (np.asarray(action) + 1.0) * 0.5 * (ub - lb)
        scaled = np.clip(scaled, lb, ub)
        obs, reward, done, info = self._wrapped_env.step(scaled)
        return (
            self._apply_normalize_obs(obs),
            reward * self._reward_scale,
            done,
            info,
        )


class StubEnv:
    """Zero-dynamics test env (reference stub_classes.py:6-50)."""

    def __init__(self, obs_dim: int = 4, action_dim: int = 2,
                 max_episode_steps: int = 10, image_shape=None):
        self._obs_dim = obs_dim
        self._image_shape = image_shape
        self.max_episode_steps = max_episode_steps
        ob = (
            np.zeros(image_shape, np.uint8)
            if image_shape
            else np.ones(obs_dim, np.float32)
        )
        self._ob = ob
        self.observation_space = Box(
            0 if image_shape else -np.inf,
            255 if image_shape else np.inf,
            shape=ob.shape,
            dtype=np.uint8 if image_shape else np.float32,
        )
        self.action_space = Box(-np.ones(action_dim), np.ones(action_dim))
        self._t = 0
        self._rng = np.random.RandomState(0)

    @property
    def _max_episode_steps(self) -> int:
        """The horizon under ``DMCEnv``'s name for it."""
        return self.max_episode_steps

    def _obs(self):
        if self._image_shape:
            return self._rng.randint(0, 255, self._image_shape, dtype=np.uint8)
        return self._ob.copy()

    def reset(self):
        self._t = 0
        return self._obs()

    def step(self, action):
        self._t += 1
        done = self._t >= self.max_episode_steps
        info = {"TimeLimit.truncated": done}
        return self._obs(), 1.0, done, info

    def render(self, **kwargs):
        h = kwargs.get("height", 16)
        w = kwargs.get("width", 16)
        return self._rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
