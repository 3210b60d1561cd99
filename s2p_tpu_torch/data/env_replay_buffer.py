"""Space-aware replay buffer, normalizers and the path builder: the port of
``s2p_tpu/data/env_replay_buffer.py`` (over the port's
``SimpleReplayBuffer``).

- ``EnvReplayBuffer`` (rlkit's ``env_replay_buffer.py``): dimensions from the
  env's spaces, discrete actions one-hot;
- ``Normalizer``/``FixedNormalizer`` (rlkit's ``normalizer.py``): running or
  given mean and std;
- ``PathBuilder``: dict-of-lists path assembly.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from s2p_tpu_torch.data.replay import SimpleReplayBuffer


def space_dim(space) -> int:
    if hasattr(space, "n"):  # discrete
        return int(space.n)
    return int(np.prod(space.shape)) if space.shape else 1


class EnvReplayBuffer(SimpleReplayBuffer):
    def __init__(self, max_replay_buffer_size: int, env, **kwargs):
        self.env = env
        self._ob_space = env.observation_space
        self._action_space = env.action_space
        self._discrete_actions = hasattr(self._action_space, "n")
        obs_dim = (
            self._ob_space.shape
            if len(self._ob_space.shape) > 1
            else space_dim(self._ob_space)
        )
        super().__init__(
            max_replay_buffer_size=max_replay_buffer_size,
            observation_dim=obs_dim,
            action_dim=space_dim(self._action_space),
            **kwargs,
        )

    def add_sample(self, observation, action, reward, terminal,
                   next_observation, **kwargs) -> None:
        if self._discrete_actions:
            onehot = np.zeros(space_dim(self._action_space))
            onehot[int(action)] = 1
            action = onehot
        super().add_sample(observation, action, reward, terminal, next_observation)


class Normalizer:
    """Running mean/std (reference normalizer.py:7-86)."""

    def __init__(self, size: int, eps: float = 1e-8,
                 default_clip_range: float = np.inf):
        self.size = size
        self.eps = eps
        self.default_clip_range = default_clip_range
        self._sum = np.zeros(size, np.float64)
        self._sumsq = np.zeros(size, np.float64)
        self._count = 0.0
        self.mean = np.zeros(size, np.float32)
        self.std = np.ones(size, np.float32)
        self.synchronized = True

    def update(self, v: np.ndarray) -> None:
        v = np.asarray(v, np.float64).reshape(-1, self.size)
        self._sum += v.sum(axis=0)
        self._sumsq += (v**2).sum(axis=0)
        self._count += len(v)
        self.synchronized = False

    def synchronize(self) -> None:
        if self._count == 0:
            return
        self.mean = (self._sum / self._count).astype(np.float32)
        var = self._sumsq / self._count - (self._sum / self._count) ** 2
        self.std = np.sqrt(np.maximum(var, self.eps**2)).astype(np.float32)
        self.synchronized = True

    def normalize(self, v: np.ndarray, clip_range: float = None) -> np.ndarray:
        if not self.synchronized:
            self.synchronize()
        clip = clip_range if clip_range is not None else self.default_clip_range
        return np.clip((v - self.mean) / self.std, -clip, clip)

    def denormalize(self, v: np.ndarray) -> np.ndarray:
        if not self.synchronized:
            self.synchronize()
        return v * self.std + self.mean


class FixedNormalizer:
    """Externally-set statistics (reference normalizer.py:88-123)."""

    def __init__(self, size: int, default_clip_range: float = np.inf, eps: float = 1e-8):
        self.size = size
        self.default_clip_range = default_clip_range
        self.mean = np.zeros(size, np.float32)
        self.std = np.ones(size, np.float32) + eps

    def set_mean(self, mean) -> None:
        self.mean = np.asarray(mean, np.float32)

    def set_std(self, std) -> None:
        self.std = np.asarray(std, np.float32)

    def normalize(self, v, clip_range: float = None):
        clip = clip_range if clip_range is not None else self.default_clip_range
        return np.clip((v - self.mean) / self.std, -clip, clip)

    def denormalize(self, v):
        return v * self.std + self.mean

    def copy_stats(self, other: "FixedNormalizer") -> None:
        self.set_mean(other.mean)
        self.set_std(other.std)


class PathBuilder(dict):
    """Incremental path assembly (reference path_builder.py)."""

    def __init__(self):
        super().__init__()
        self._path_length = 0

    def add_all(self, **key_to_value) -> None:
        for k, v in key_to_value.items():
            self.setdefault(k, []).append(v)
        self._path_length += 1

    def get_all_stacked(self) -> Dict[str, np.ndarray]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            if v and isinstance(v[0], dict):
                out[k] = v  # info dicts stay as lists
            else:
                out[k] = np.array(v)
        return out

    def __len__(self) -> int:
        return self._path_length
