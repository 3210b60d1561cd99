"""Goal-conditioned / dict-observation collectors + in-place sampling: the
port of ``s2p_tpu/samplers/extra_collectors.py``.

Capability contracts (reference: rlkit/samplers/data_collector/
path_collector.py:121-194 — GoalConditionedPathCollector,
ObsDictPathCollector — and rlkit/samplers/in_place.py InPlacePathSampler):
flatten dict observations into the policy input by concatenating the
configured observation + desired-goal keys; the in-place sampler is a
fixed-env/policy convenience around rollout."""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from s2p_tpu_torch.samplers.path_collector import MdpPathCollector
from s2p_tpu_torch.samplers.rollout import rollout as default_rollout


class ObsDictPathCollector(MdpPathCollector):
    """Rollout over dict observations, feeding obs[observation_key] to the
    policy (reference :164-194)."""

    def __init__(self, env, policy, observation_key: str = "observation",
                 **kwargs):
        def obs_fn(o):
            return o[observation_key]

        rollout_fn = partial(
            default_rollout, preprocess_obs_for_policy_fn=obs_fn
        )
        super().__init__(env, policy, rollout_fn=rollout_fn, **kwargs)
        self._observation_key = observation_key

    def get_snapshot(self):
        snap = super().get_snapshot()
        snap["observation_key"] = self._observation_key
        return snap


class GoalConditionedPathCollector(MdpPathCollector):
    """Policy input = concat(obs[observation_key], obs[desired_goal_key])
    (reference :121-162)."""

    def __init__(self, env, policy, observation_key: str = "observation",
                 desired_goal_key: str = "desired_goal", **kwargs):
        def obs_fn(o):
            return np.concatenate([o[observation_key], o[desired_goal_key]])

        rollout_fn = partial(
            default_rollout, preprocess_obs_for_policy_fn=obs_fn
        )
        super().__init__(env, policy, rollout_fn=rollout_fn, **kwargs)
        self._observation_key = observation_key
        self._desired_goal_key = desired_goal_key

    def get_snapshot(self):
        snap = super().get_snapshot()
        snap["observation_key"] = self._observation_key
        snap["desired_goal_key"] = self._desired_goal_key
        return snap


class InPlacePathSampler:
    """Fixed env/policy path sampler (reference in_place.py): obtain_samples
    collects up to max_samples steps of max_path_length rollouts."""

    def __init__(self, env, policy, max_path_length: int):
        self.env = env
        self.policy = policy
        self.max_path_length = max_path_length

    def obtain_samples(self, max_samples: int,
                       max_trajs: Optional[int] = None,
                       accum_context: bool = False):
        paths, n_steps = [], 0
        while n_steps < max_samples and (
            max_trajs is None or len(paths) < max_trajs
        ):
            path = default_rollout(
                self.env, self.policy, max_path_length=self.max_path_length
            )
            paths.append(path)
            n_steps += len(path["actions"])
        return paths, n_steps
