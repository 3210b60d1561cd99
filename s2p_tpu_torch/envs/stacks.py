"""Frame/state stacking wrappers + env factory: the port of
``s2p_tpu/envs/stacks.py`` (plain numpy).

Capability contracts:
- ``FrameStack`` (reference: examples/iql/custom_gym_to_multi_env.py:134-167):
  k-frame image stack. The reference stacks CHW frames on the channel axis
  giving [C·k, H, W]; the JAX package and the port keep NHWC and stack on
  the LAST axis, giving [H, W, C·k] — the same information.
- ``StateStack`` (:169-206): qpos-only k-stack (cheetah ``qpos_idx=8``) —
  the state-input variant used by state-RL ablations.
- ``make()`` (reference: rlkit/envs/make_env.py:37-75): env factory with the
  DMC registry, optional NormalizedBoxEnv wrap.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from s2p_tpu_torch.envs.dmc import DMC_ENVS, make_dmc
from s2p_tpu_torch.envs.wrappers import Box, NormalizedBoxEnv, ProxyEnv

QPOS_IDX = {"cheetah": 8}


class FrameStack(ProxyEnv):
    def __init__(self, env, k: int):
        super().__init__(env)
        self._k = k
        self._frames: deque = deque([], maxlen=k)
        shp = env.observation_space.shape  # (H, W, C)
        self.observation_space = Box(
            0, 255, shape=shp[:-1] + (shp[-1] * k,),
            dtype=env.observation_space.dtype,
        )

    def reset(self, **kwargs):
        obs = self._wrapped_env.reset(**kwargs)
        for _ in range(self._k):
            self._frames.append(obs)
        return self._get_obs()

    def step(self, action):
        obs, reward, done, info = self._wrapped_env.step(action)
        self._frames.append(obs)
        return self._get_obs(), reward, done, info

    def _get_obs(self):
        assert len(self._frames) == self._k
        return np.concatenate(list(self._frames), axis=-1)


class StateStack(ProxyEnv):
    def __init__(self, env, k: int, state_type: str = "qpos",
                 env_id: Optional[str] = None):
        super().__init__(env)
        self._k = k
        self._frames: deque = deque([], maxlen=k)
        domain = (env_id or "cheetah").split("-")[0]
        if domain not in QPOS_IDX:
            raise ValueError(f"qpos index unknown for {domain!r}")
        self.qpos_idx = QPOS_IDX[domain]
        self.state_type = state_type
        lo = np.tile(env.observation_space.low[: self.qpos_idx], k)
        hi = np.tile(env.observation_space.high[: self.qpos_idx], k)
        self.observation_space = Box(lo, hi, dtype=env.observation_space.dtype)

    def _slice(self, obs):
        return obs[: self.qpos_idx]

    def reset(self, **kwargs):
        obs = self._slice(self._wrapped_env.reset(**kwargs))
        for _ in range(self._k):
            self._frames.append(obs)
        return self._get_obs()

    def step(self, action):
        obs, reward, done, info = self._wrapped_env.step(action)
        self._frames.append(self._slice(obs))
        return self._get_obs(), reward, done, info

    def _get_obs(self):
        assert len(self._frames) == self._k
        return np.concatenate(list(self._frames), axis=0)


def make(
    env_id: Optional[str] = None,
    env_class=None,
    env_kwargs: Optional[dict] = None,
    normalize_env: bool = True,
    frame_stack: Optional[int] = None,
    state_stack: Optional[int] = None,
):
    """Env factory (reference make_env.py:37-75): DMC registry ids, custom
    classes, optional normalization and stacking."""
    env_kwargs = env_kwargs or {}
    if env_class is not None:
        env = env_class(**env_kwargs)
    else:
        if env_id is None:
            raise ValueError("make needs an env_id or an env_class")
        key = env_id
        if key not in DMC_ENVS:
            for known in DMC_ENVS:
                if key.split("-")[0] == known.split("-")[0]:
                    key = known
                    break
        env = make_dmc(key, **env_kwargs)
    if frame_stack:
        env = FrameStack(env, frame_stack)
    if state_stack:
        env = StateStack(env, state_stack, env_id=env_id)
    if normalize_env:
        env = NormalizedBoxEnv(env)
    return env
