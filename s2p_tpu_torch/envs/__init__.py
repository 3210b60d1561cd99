"""Environments of the port (the port of ``s2p_tpu/envs``' wrappers and
DeepMind Control factory)."""

from s2p_tpu_torch.envs.wrappers import Box, NormalizedBoxEnv, ProxyEnv, StubEnv
from s2p_tpu_torch.envs.dmc import DMC_ENVS, DMCEnv, make_dmc

__all__ = ["Box", "NormalizedBoxEnv", "ProxyEnv", "StubEnv", "DMC_ENVS", "DMCEnv", "make_dmc"]
