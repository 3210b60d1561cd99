"""The RL loops' protocols and the offline loop (the port of the env-free
part of ``s2p_tpu/core``)."""

from s2p_tpu_torch.core.simple_offline_rl_algorithm import SimpleOfflineRlAlgorithm
from s2p_tpu_torch.core.trainer import LossFunction, Serializable, Trainer

__all__ = ["SimpleOfflineRlAlgorithm", "LossFunction", "Serializable", "Trainer"]
