"""DeepMind Control envs: the port of ``s2p_tpu/envs/dmc.py`` (plain numpy).

cheetah-run, walker-walk and the other suite tasks of the reference's
registry behind the gym-classic API: ``frame_skip`` action repeat, state or
NHWC uint8 pixel observations, ``_max_episode_steps = 1000 / frame_skip``
with ``TimeLimit.truncated`` at the horizon, and ``set_state`` for
state-to-render replay. It wraps ``dm_control.suite`` directly, as the JAX
package does; ``dm_control`` is imported when an env is made, so the package
imports where it is not installed, and ``make_dmc`` raises there.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from s2p_tpu_torch.envs.wrappers import Box

DMC_ENVS = {
    # env_name -> (domain, task, default frame_skip)
    "cheetah-run": ("cheetah", "run", 4),
    "walker-walk": ("walker", "walk", 2),
    "ball_in_cup-catch": ("ball_in_cup", "catch", 4),
    "cartpole-swingup": ("cartpole", "swingup", 8),
    "reacher-easy": ("reacher", "easy", 4),
    "finger-spin": ("finger", "spin", 2),
}


def _flatten_obs(obs_dict) -> np.ndarray:
    return np.concatenate(
        [np.asarray(v, np.float32).ravel() for v in obs_dict.values()]
    )


class DMCEnv:
    """gym-classic API over dm_control.suite with action repeat + pixels."""

    def __init__(
        self,
        domain_name: str,
        task_name: str,
        frame_skip: int = 1,
        from_pixels: bool = False,
        height: int = 100,
        width: int = 100,
        camera_id: int = 0,
        seed: Optional[int] = None,
        episode_length: int = 1000,
    ):
        # headless MuJoCo rendering through EGL (the reference starts an Xvfb
        # server instead); it must be chosen before MuJoCo is first imported
        os.environ.setdefault("MUJOCO_GL", "egl")
        try:
            from dm_control import suite
        except ImportError as e:
            raise ImportError("DeepMind Control envs need dm_control, which is not "
                              "installed") from e

        self._env = suite.load(
            domain_name, task_name,
            task_kwargs={"random": seed} if seed is not None else None,
        )
        self.frame_skip = self.action_repeat = frame_skip
        self.from_pixels = from_pixels
        self._height, self._width, self._camera_id = height, width, camera_id
        self._max_episode_steps = episode_length // frame_skip
        self._t = 0

        spec = self._env.action_spec()
        self.action_space = Box(
            spec.minimum.astype(np.float32), spec.maximum.astype(np.float32)
        )
        ts = self._env.reset()
        state = _flatten_obs(ts.observation)
        self.state_dim = state.shape[0]
        if from_pixels:
            self.observation_space = Box(
                0, 255, shape=(height, width, 3), dtype=np.uint8
            )
        else:
            self.observation_space = Box(
                -np.inf, np.inf, shape=state.shape, dtype=np.float32
            )

    # -- helpers -----------------------------------------------------------
    def render(self, mode: str = "rgb_array", height: Optional[int] = None,
               width: Optional[int] = None, camera_id: Optional[int] = None):
        return self._env.physics.render(
            height=height or self._height,
            width=width or self._width,
            camera_id=camera_id if camera_id is not None else self._camera_id,
        )

    def _get_obs(self, ts) -> np.ndarray:
        if self.from_pixels:
            return self.render().astype(np.uint8)
        return _flatten_obs(ts.observation)

    @property
    def physics(self):
        return self._env.physics

    def set_state(self, qpos: np.ndarray, qvel: np.ndarray) -> None:
        """State→render replay hook (reference
        multiworld_custom gym_to_multi_env set_state usage)."""
        with self._env.physics.reset_context():
            self._env.physics.data.qpos[:] = qpos
            self._env.physics.data.qvel[:] = qvel

    # -- gym-classic API ----------------------------------------------------
    def reset(self) -> np.ndarray:
        self._t = 0
        ts = self._env.reset()
        return self._get_obs(ts)

    def step(self, action) -> Tuple[np.ndarray, float, bool, dict]:
        action = np.clip(
            np.asarray(action, np.float32),
            self.action_space.low, self.action_space.high,
        )
        reward = 0.0
        ts = None
        for _ in range(self.frame_skip):
            ts = self._env.step(action)
            reward += ts.reward or 0.0
            if ts.last():
                break
        self._t += 1
        truncated = self._t >= self._max_episode_steps or bool(ts.last())
        done = truncated  # DMC has no terminal states (SURVEY: terminals==0)
        info = {"TimeLimit.truncated": truncated}
        return self._get_obs(ts), reward, done, info


def make_dmc(
    env_name: Optional[str] = None,
    domain_name: Optional[str] = None,
    task_name: Optional[str] = None,
    frame_skip: Optional[int] = None,
    from_pixels: bool = False,
    height: int = 100,
    width: int = 100,
    seed: Optional[int] = None,
) -> DMCEnv:
    """Factory matching the reference registry (slac/env.py:7-17)."""
    if env_name is not None:
        domain_name, task_name, default_skip = DMC_ENVS[env_name]
        frame_skip = frame_skip or default_skip
    if not (domain_name and task_name):
        raise ValueError("make_dmc needs env_name, or domain_name and task_name")
    return DMCEnv(
        domain_name, task_name, frame_skip=frame_skip or 1,
        from_pixels=from_pixels, height=height, width=width, seed=seed,
    )
