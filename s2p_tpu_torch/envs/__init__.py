"""Environments of the port (the port of ``s2p_tpu/envs``): the wrappers
and stub env, the DeepMind Control factory, the frame and state stacks, the
extra wrappers, the dict-observation image envs and the multitask
families."""

from s2p_tpu_torch.envs.wrappers import Box, NormalizedBoxEnv, ProxyEnv, StubEnv
from s2p_tpu_torch.envs.dmc import DMC_ENVS, DMCEnv, make_dmc
from s2p_tpu_torch.envs.stacks import FrameStack, StateStack, make
from s2p_tpu_torch.envs.extra_wrappers import (
    DiscretizeEnv,
    HistoryEnv,
    RewardWrapperEnv,
    StackObservationEnv,
)
from s2p_tpu_torch.envs.image_env import GymToMultiEnv, ImageEnv, MujocoGymToMultiEnv
from s2p_tpu_torch.envs.multitask import (
    DirectionTaskEnv,
    PointRobotEnv,
    RandParamEnv,
    VelocityTaskEnv,
)

__all__ = [
    "Box",
    "NormalizedBoxEnv",
    "ProxyEnv",
    "StubEnv",
    "DMC_ENVS",
    "DMCEnv",
    "make_dmc",
    "FrameStack",
    "StateStack",
    "make",
    "DiscretizeEnv",
    "HistoryEnv",
    "RewardWrapperEnv",
    "StackObservationEnv",
    "GymToMultiEnv",
    "ImageEnv",
    "MujocoGymToMultiEnv",
    "DirectionTaskEnv",
    "PointRobotEnv",
    "RandParamEnv",
    "VelocityTaskEnv",
]
