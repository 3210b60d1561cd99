"""Goal-conditioned (HER-style) relabeling replay buffer: the port of
``s2p_tpu/data/her_buffer.py`` (plain numpy on the host, the same draws).

Capability contract (reference: rlkit/data_management/
obs_dict_replay_buffer.py:7-305 ``ObsDictRelabelingBuffer``): store dict
observations (observation / desired_goal / achieved_goal keys), sample
batches where a configurable fraction of goals is relabeled — future
achieved goals from the same path ("future" strategy) or env-resampled
goals — recomputing rewards through the env's ``compute_rewards``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ObsDictRelabelingBuffer:
    def __init__(
        self,
        max_size: int,
        env,
        fraction_goals_rollout_goals: float = 0.2,
        fraction_goals_env_goals: float = 0.0,
        observation_key: str = "observation",
        desired_goal_key: str = "desired_goal",
        achieved_goal_key: str = "achieved_goal",
    ):
        self.max_size = int(max_size)
        self.env = env
        self.fraction_goals_rollout_goals = fraction_goals_rollout_goals
        self.fraction_goals_env_goals = fraction_goals_env_goals
        self.observation_key = observation_key
        self.desired_goal_key = desired_goal_key
        self.achieved_goal_key = achieved_goal_key

        self._obs: Optional[np.ndarray] = None
        self._next_obs = None
        self._achieved = None
        self._next_achieved = None
        self._goals = None
        self._actions = None
        self._terminals = None
        # per-sample index of its path's final step (for 'future' sampling)
        self._path_end = None
        self._top = 0
        self._size = 0

    def _init_storage(self, obs_dim, goal_dim, act_dim):
        z = lambda d: np.zeros((self.max_size, d), np.float32)
        self._obs, self._next_obs = z(obs_dim), z(obs_dim)
        self._achieved, self._next_achieved = z(goal_dim), z(goal_dim)
        self._goals = z(goal_dim)
        self._actions = z(act_dim)
        self._terminals = np.zeros((self.max_size, 1), np.float32)
        self._path_end = np.zeros(self.max_size, np.int64)

    def add_path(self, path: Dict[str, np.ndarray]) -> None:
        obs_list = path["observations"]
        next_list = path["next_observations"]
        actions = np.asarray(path["actions"])
        terminals = np.asarray(path["terminals"]).reshape(-1, 1)
        T = len(actions)
        if self._obs is None:
            self._init_storage(
                len(obs_list[0][self.observation_key]),
                len(obs_list[0][self.desired_goal_key]),
                actions.shape[1],
            )
        if self._top + T > self.max_size:
            raise ValueError("HER buffer: no wraparound paths")
        sl = slice(self._top, self._top + T)
        self._obs[sl] = [o[self.observation_key] for o in obs_list]
        self._next_obs[sl] = [o[self.observation_key] for o in next_list]
        self._achieved[sl] = [o[self.achieved_goal_key] for o in obs_list]
        self._next_achieved[sl] = [o[self.achieved_goal_key] for o in next_list]
        self._goals[sl] = [o[self.desired_goal_key] for o in obs_list]
        self._actions[sl] = actions
        self._terminals[sl] = terminals
        self._path_end[sl] = self._top + T
        self._top = (self._top + T) % self.max_size
        self._size = min(self._size + T, self.max_size)

    def __len__(self) -> int:
        return self._size

    def random_batch(self, batch_size: int,
                     rng: Optional[np.random.RandomState] = None) -> Dict:
        rng = rng or np.random
        idx = rng.randint(0, self._size, batch_size)
        goals = self._goals[idx].copy()

        n_rollout = int(batch_size * self.fraction_goals_rollout_goals)
        n_env = int(batch_size * self.fraction_goals_env_goals)
        n_future = batch_size - n_rollout - n_env
        # future relabeling: uniform future step within the same path
        if n_future > 0:
            rows = np.arange(batch_size) >= (n_rollout + n_env)
            fi = idx[rows]
            ends = self._path_end[fi]
            future = (fi + (rng.random_sample(len(fi)) * (ends - fi)).astype(
                np.int64
            )).clip(max=self._size - 1)
            goals[rows] = self._next_achieved[future]
        if n_env > 0 and hasattr(self.env, "sample_goals"):
            rows = slice(n_rollout, n_rollout + n_env)
            goals[rows] = self.env.sample_goals(n_env)

        rewards = self._compute_rewards(self._next_achieved[idx], goals)
        obs = np.concatenate([self._obs[idx], goals], axis=1)
        next_obs = np.concatenate([self._next_obs[idx], goals], axis=1)
        return dict(
            observations=obs,
            actions=self._actions[idx],
            rewards=rewards.reshape(-1, 1),
            terminals=self._terminals[idx],
            next_observations=next_obs,
            resampled_goals=goals,
        )

    def _compute_rewards(self, achieved, goals) -> np.ndarray:
        if hasattr(self.env, "compute_rewards"):
            return np.asarray(self.env.compute_rewards(achieved, goals))
        # default sparse: 0 within eps, −1 outside
        d = np.linalg.norm(achieved - goals, axis=1)
        return -(d > 0.05).astype(np.float32)

    # protocol no-ops
    def get_diagnostics(self):
        return {"size": float(self._size)}

    def end_epoch(self, epoch):
        return
