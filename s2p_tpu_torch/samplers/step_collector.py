"""Step collector for online RL: the port of
``s2p_tpu/samplers/step_collector.py``.

``MdpStepCollector`` (rlkit's ``data_collector/step_collector.py``) steps
the env one step at a time and keeps the path in progress; a finished or
max-length path joins the epoch's deque, and a short path that ended
without the env's done is dropped under ``discard_incomplete_paths``, its
steps never counted in the lifetime totals. The diagnostics keys are the
frozen-csv set shared through ``EpochPathLog``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from s2p_tpu_torch.samplers.path_collector import EpochPathLog

_PATH_KEYS = ("observations", "actions", "rewards", "next_observations",
              "terminals", "dones", "agent_infos", "env_infos")


class MdpStepCollector:
    def __init__(
        self,
        env,
        policy,
        max_num_epoch_paths_saved: Optional[int] = None,
        render: bool = False,
        render_kwargs: Optional[dict] = None,
    ):
        self.env = env
        self.policy = policy
        self.log = EpochPathLog(max_num_epoch_paths_saved)
        self.render = render
        self.render_kwargs = render_kwargs or {}
        self._partial: Optional[dict] = None  # in-progress path columns
        self._obs: Optional[np.ndarray] = None

    def collect_new_steps(self, max_path_length: int, num_steps: int,
                          discard_incomplete_paths: bool) -> list:
        return [self.collect_one_step(max_path_length,
                                      discard_incomplete_paths)
                for _ in range(num_steps)]

    def collect_one_step(self, max_path_length: int,
                         discard_incomplete_paths: bool) -> dict:
        if self._partial is None:
            self.policy.reset()
            self._obs = self.env.reset()
            self._partial = {k: [] for k in _PATH_KEYS}

        obs = self._obs
        action, agent_info = self.policy.get_action(obs)
        next_obs, reward, done, env_info = self.env.step(
            np.array(action, copy=True)
        )
        if self.render:
            self.env.render(**self.render_kwargs)
        # a TimeLimit truncation is a done (episode ends) but NOT a
        # terminal (no absorbing-state bootstrap cutoff)
        terminal = bool(done) and not env_info.get(
            "TimeLimit.truncated", False
        )

        step = dict(
            observation=obs, action=action, reward=reward,
            next_observation=next_obs, terminal=terminal, done=bool(done),
            agent_info=agent_info, env_info=env_info,
        )
        row = (obs, action, reward, next_obs, terminal, bool(done),
               agent_info, env_info)
        for key, value in zip(_PATH_KEYS, row):
            self._partial[key].append(value)

        if done or len(self._partial["actions"]) >= max_path_length:
            self._finish_path(max_path_length, discard_incomplete_paths)
        else:
            self._obs = next_obs
        return step

    def _finish_path(self, max_path_length: int,
                     discard_incomplete_paths: bool) -> None:
        cols = self._partial
        self._partial = None
        self._obs = None
        # reference _handle_rollout_ending: a path shorter than
        # max_path_length whose final raw env done is False is dropped
        # (and its steps never hit the lifetime totals) when
        # discard_incomplete_paths
        incomplete = (len(cols["actions"]) != max_path_length
                      and not cols["dones"][-1])
        if incomplete and discard_incomplete_paths:
            return
        path = {k: np.array(cols[k]) for k in
                ("observations", "actions", "next_observations")}
        path.update({k: np.array(cols[k]).reshape(-1, 1) for k in
                     ("rewards", "terminals", "dones")})
        path["agent_infos"] = cols["agent_infos"]
        path["env_infos"] = cols["env_infos"]
        self.log.record(path)

    def get_epoch_paths(self):
        return self.log.paths

    def end_epoch(self, epoch: int) -> None:
        self.log.clear_epoch()
        self._partial = None
        self._obs = None

    def get_diagnostics(self):
        return self.log.diagnostics()

    def get_snapshot(self) -> dict:
        return dict(policy=self.policy, env=self.env)
