"""Multitask (meta-RL) environments: the port of ``s2p_tpu/envs/multitask.py``
(plain numpy).

Capability contract (reference: rlkit/envs/pearl_envs/ — ant-dir/goal,
half-cheetah-dir/vel, humanoid-dir, point-robot, rand-param envs; ~1.4k LoC
of gym-mujoco subclasses). The PEARL env API is: ``sample_tasks(n)``,
``reset_task(idx)``, ``get_all_task_idx()``, tasks as dicts.

As in the JAX package, the velocity/direction task families are generic wrappers
over the dm_control envs (reward recomputed from the physics root
velocity), and the point robot is pure numpy — no mujoco XML assets to
vendor. Rand-param dynamics variation is exposed via a body-mass scaling
wrapper."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from s2p_tpu_torch.envs.wrappers import Box, ProxyEnv


class MultitaskEnvMixin:
    tasks: List[Dict]

    def get_all_task_idx(self) -> List[int]:
        return list(range(len(self.tasks)))

    def reset_task(self, idx: int):
        self._task = self.tasks[idx]
        self._set_task(self._task)
        return self.reset()

    def _set_task(self, task: Dict) -> None:
        raise NotImplementedError


class VelocityTaskEnv(ProxyEnv, MultitaskEnvMixin):
    """reward = −|v_x − target| + ctrl bonus proxy (reference
    half_cheetah_vel.py semantics over dm_control physics)."""

    def __init__(self, env, num_tasks: int = 10, max_vel: float = 3.0,
                 seed: int = 0):
        super().__init__(env)
        rng = np.random.RandomState(seed)
        self.tasks = [{"velocity": float(v)}
                      for v in rng.uniform(0.0, max_vel, num_tasks)]
        self._task = self.tasks[0]

    def _set_task(self, task: Dict) -> None:
        self._task = task

    def sample_tasks(self, n: int, seed: Optional[int] = None) -> List[Dict]:
        rng = np.random.RandomState(seed)
        return [{"velocity": float(v)} for v in rng.uniform(0.0, 3.0, n)]

    def _root_vel(self) -> float:
        return float(self._wrapped_env.physics.data.qvel[0])

    def step(self, action):
        obs, _, done, info = self._wrapped_env.step(action)
        vel = self._root_vel()
        reward = -abs(vel - self._task["velocity"]) - 0.05 * float(
            np.square(action).sum()
        )
        info["velocity"] = vel
        return obs, reward, done, info


class DirectionTaskEnv(ProxyEnv, MultitaskEnvMixin):
    """reward = direction · v_x (reference half_cheetah_dir / ant_dir)."""

    def __init__(self, env, seed: int = 0):
        super().__init__(env)
        self.tasks = [{"direction": -1.0}, {"direction": 1.0}]
        self._task = self.tasks[1]

    def _set_task(self, task: Dict) -> None:
        self._task = task

    def sample_tasks(self, n: int, seed: Optional[int] = None) -> List[Dict]:
        rng = np.random.RandomState(seed)
        return [{"direction": float(d)}
                for d in rng.choice([-1.0, 1.0], n)]

    def step(self, action):
        obs, _, done, info = self._wrapped_env.step(action)
        vel = float(self._wrapped_env.physics.data.qvel[0])
        reward = self._task["direction"] * vel - 0.05 * float(
            np.square(action).sum()
        )
        return obs, reward, done, info


class RandParamEnv(ProxyEnv, MultitaskEnvMixin):
    """Dynamics-variation tasks: scale body masses per task (reference
    rand_param_envs hopper/walker)."""

    def __init__(self, env, num_tasks: int = 10, log_scale_limit: float = 0.5,
                 seed: int = 0):
        super().__init__(env)
        self._base_mass = env.physics.model.body_mass.copy()
        rng = np.random.RandomState(seed)
        self.tasks = [
            {"mass_scale": float(np.exp(rng.uniform(-log_scale_limit,
                                                    log_scale_limit)))}
            for _ in range(num_tasks)
        ]
        self._task = self.tasks[0]

    def _set_task(self, task: Dict) -> None:
        self._task = task
        self._wrapped_env.physics.model.body_mass[:] = (
            self._base_mass * task["mass_scale"]
        )

    def sample_tasks(self, n: int, seed: Optional[int] = None) -> List[Dict]:
        rng = np.random.RandomState(seed)
        return [{"mass_scale": float(np.exp(rng.uniform(-0.5, 0.5)))}
                for _ in range(n)]


class PointRobotEnv(MultitaskEnvMixin):
    """2-D point robot navigating to per-task goals on a circle
    (reference pearl_envs/point_robot.py); pure numpy."""

    def __init__(self, num_tasks: int = 10, radius: float = 1.0,
                 max_episode_steps: int = 20, seed: int = 0):
        rng = np.random.RandomState(seed)
        angles = rng.uniform(0, 2 * np.pi, num_tasks)
        self.tasks = [{"goal": np.array([radius * np.cos(a),
                                         radius * np.sin(a)], np.float32)}
                      for a in angles]
        self._task = self.tasks[0]
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(-np.inf, np.inf, shape=(2,))
        self.action_space = Box(-0.1 * np.ones(2), 0.1 * np.ones(2))
        self._pos = np.zeros(2, np.float32)
        self._t = 0

    def _set_task(self, task: Dict) -> None:
        self._task = task

    def sample_tasks(self, n: int, seed: Optional[int] = None) -> List[Dict]:
        rng = np.random.RandomState(seed)
        angles = rng.uniform(0, 2 * np.pi, n)
        return [{"goal": np.array([np.cos(a), np.sin(a)], np.float32)}
                for a in angles]

    def reset(self):
        self._pos = np.zeros(2, np.float32)
        self._t = 0
        return self._pos.copy()

    def step(self, action):
        self._pos = self._pos + np.clip(action, -0.1, 0.1)
        self._t += 1
        reward = -float(np.linalg.norm(self._pos - self._task["goal"]))
        done = self._t >= self.max_episode_steps
        return self._pos.copy(), reward, done, {"TimeLimit.truncated": done}
