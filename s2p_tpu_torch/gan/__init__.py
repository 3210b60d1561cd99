from s2p_tpu_torch.gan.generator import (
    MATNorm,
    MATResBlock,
    PositionalEmbedding,
    S2PGenerator,
    resolution_chain,
)
from s2p_tpu_torch.gan.fast_inference import fast_apply, fuse_fast_params, generate_rollout_fast
from s2p_tpu_torch.gan.rollout import generate_rollout

__all__ = [
    "MATNorm",
    "MATResBlock",
    "PositionalEmbedding",
    "S2PGenerator",
    "resolution_chain",
    "fast_apply",
    "fuse_fast_params",
    "generate_rollout_fast",
    "generate_rollout",
]
