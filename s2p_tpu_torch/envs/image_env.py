"""Dict-observation image env + multiworld-style adapters: the port of
``s2p_tpu/envs/image_env.py`` (plain numpy).

Capability contracts:
- ``ImageEnv`` (reference: multiworld_custom/core/image_env.py:15): wrap an
  env so observations become dicts with image keys (image_observation /
  image_desired_goal / image_achieved_goal) rendered at ``imsize``,
  normalized to [0, 1] floats when requested.
- ``GymToMultiEnv`` / ``MujocoGymToMultiEnv`` (reference: multiworld_custom/
  core/gym_to_multi_env.py): dict-obs adapters over flat-obs envs; the
  mujoco variant exposes ``set_state(qpos, qvel)`` for state→render replay
  (examples/iql/custom_gym_to_multi_env.py:18-24) — the hook the S2P data
  pipeline uses to render images for state-only transitions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from s2p_tpu_torch.envs.wrappers import Box, ProxyEnv


class GymToMultiEnv(ProxyEnv):
    """Flat obs → {'observation': obs, 'state_observation': obs}."""

    def __init__(self, env):
        super().__init__(env)
        self.observation_space = env.observation_space

    def _wrap(self, obs) -> Dict[str, np.ndarray]:
        return dict(observation=obs, state_observation=obs)

    def reset(self, **kwargs):
        return self._wrap(self._wrapped_env.reset(**kwargs))

    def step(self, action):
        obs, r, d, info = self._wrapped_env.step(action)
        return self._wrap(obs), r, d, info


class MujocoGymToMultiEnv(GymToMultiEnv):
    """Adds qpos/qvel state replay (reference gym_to_multi_env.py set_state
    usage at custom_gym_to_multi_env.py:18-24)."""

    def set_state(self, qpos: np.ndarray, qvel: np.ndarray) -> None:
        self._wrapped_env.set_state(qpos, qvel)

    def get_state(self):
        physics = self._wrapped_env.physics
        return physics.data.qpos.copy(), physics.data.qvel.copy()


class ImageEnv(ProxyEnv):
    def __init__(
        self,
        wrapped_env,
        imsize: int = 84,
        transpose: bool = False,  # reference flattens CHW; we keep NHWC
        normalize: bool = True,
        reward_type: str = "wrapped_env",
        recompute_reward: bool = False,
    ):
        super().__init__(wrapped_env)
        self.imsize = imsize
        self.normalize = normalize
        self.reward_type = reward_type
        self.recompute_reward = recompute_reward
        self.image_length = imsize * imsize * 3
        self.observation_space = Box(
            0.0, 1.0 if normalize else 255.0,
            shape=(imsize, imsize, 3),
            dtype=np.float32 if normalize else np.uint8,
        )

    def _image(self) -> np.ndarray:
        img = np.asarray(
            self._wrapped_env.render(height=self.imsize, width=self.imsize)
        )
        if self.normalize:
            return img.astype(np.float32) / 255.0
        return img.astype(np.uint8)

    def _wrap(self, obs) -> Dict[str, np.ndarray]:
        img = self._image()
        out = dict(obs) if isinstance(obs, dict) else dict(state_observation=obs)
        out.update(
            image_observation=img,
            image_desired_goal=img,
            image_achieved_goal=img,
            observation=img,
        )
        return out

    def reset(self, **kwargs):
        return self._wrap(self._wrapped_env.reset(**kwargs))

    def step(self, action):
        obs, r, d, info = self._wrapped_env.step(action)
        return self._wrap(obs), r, d, info
