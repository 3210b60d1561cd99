"""Agents, rollouts and collectors of the port (the port of
``s2p_tpu/samplers``: agents, rollout, path and step collectors, the
dict-observation and goal-conditioned collectors and the in-place
sampler)."""

from s2p_tpu_torch.samplers.agents import PolicyAgent, RandomAgent, SlacObservation
from s2p_tpu_torch.samplers.rollout import rollout
from s2p_tpu_torch.samplers.path_collector import EpochPathLog, MdpPathCollector
from s2p_tpu_torch.samplers.step_collector import MdpStepCollector
from s2p_tpu_torch.samplers.extra_collectors import (
    GoalConditionedPathCollector,
    InPlacePathSampler,
    ObsDictPathCollector,
)

__all__ = ["PolicyAgent", "RandomAgent", "SlacObservation", "rollout", "EpochPathLog",
           "MdpPathCollector", "MdpStepCollector", "GoalConditionedPathCollector",
           "InPlacePathSampler", "ObsDictPathCollector"]
