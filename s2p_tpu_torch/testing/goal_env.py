"""A goal-conditioned point robot and a multitask-batch adapter, for driving
the goal-conditioned and multitask path without MuJoCo.

- ``PointRobotGoalEnv``: ``envs.multitask.PointRobotEnv`` with dict
  observations, ``observation`` and ``achieved_goal`` the position,
  ``desired_goal`` the current task's goal; ``compute_rewards`` is the
  env's own dense reward, −‖achieved − goal‖, over a batch (what
  ``data.her_buffer.ObsDictRelabelingBuffer`` relabels with);
  ``sample_goals(n)`` draws goals on the unit circle from a seeded
  ``RandomState``.
- ``TaskBatchTrainer``: the trainer protocol over
  ``MultiTaskReplayBuffer.sample_tasks_batch``'s ``[tasks, batch, ...]``
  arrays, flattened to ``[tasks · batch, ...]`` for a flat-batch trainer
  (``rl.SACTrainer``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from s2p_tpu_torch.envs.multitask import PointRobotEnv
from s2p_tpu_torch.envs.wrappers import ProxyEnv


class PointRobotGoalEnv(ProxyEnv):
    def __init__(self, num_tasks: int = 10, max_episode_steps: int = 20, seed: int = 0):
        super().__init__(PointRobotEnv(num_tasks, max_episode_steps=max_episode_steps, seed=seed))
        self._goal_rng = np.random.RandomState(seed + 1)

    def _wrap(self, pos: np.ndarray) -> Dict[str, np.ndarray]:
        return dict(observation=pos, desired_goal=self._wrapped_env._task["goal"].copy(),
                    achieved_goal=pos.copy())

    def reset(self):
        return self._wrap(self._wrapped_env.reset())

    def step(self, action):
        pos, reward, done, info = self._wrapped_env.step(action)
        return self._wrap(pos), reward, done, info

    def reset_task(self, idx: int):
        self._wrapped_env.reset_task(idx)
        return self.reset()

    @staticmethod
    def compute_rewards(achieved: np.ndarray, goals: np.ndarray) -> np.ndarray:
        return -np.linalg.norm(achieved - goals, axis=1)

    def sample_goals(self, n: int) -> np.ndarray:
        angles = self._goal_rng.uniform(0, 2 * np.pi, n)
        return np.stack([np.cos(angles), np.sin(angles)], axis=1).astype(np.float32)


class TaskBatchTrainer:
    def __init__(self, trainer) -> None:
        self.trainer = trainer
        self.n_train_calls = 0

    def train(self, batch: Mapping[str, np.ndarray]) -> Any:
        self.n_train_calls += 1
        return self.trainer.train({k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()})

    def end_epoch(self, epoch: int) -> None:
        self.trainer.end_epoch(epoch)
