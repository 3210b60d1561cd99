"""The RL loops and their protocols (the port of ``s2p_tpu/core``): the
batch and online loops, the env-free offline loop, the trainer protocols
and the eval-video hook."""

from s2p_tpu_torch.core.batch_rl_algorithm import BatchRLAlgorithm
from s2p_tpu_torch.core.online_rl_algorithm import OnlineRLAlgorithm
from s2p_tpu_torch.core.simple_offline_rl_algorithm import SimpleOfflineRlAlgorithm
from s2p_tpu_torch.core.trainer import LossFunction, Serializable, Trainer
from s2p_tpu_torch.core.video import VideoSaveFunction, dump_video, write_video

__all__ = ["BatchRLAlgorithm", "OnlineRLAlgorithm", "SimpleOfflineRlAlgorithm", "LossFunction",
           "Serializable", "Trainer", "VideoSaveFunction", "dump_video", "write_video"]
