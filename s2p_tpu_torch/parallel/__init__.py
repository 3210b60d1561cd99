"""Multi-process training on ``torch.distributed``: the port of
``s2p_tpu/parallel``."""

from s2p_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    NamedSharding,
    all_gather_cat,
    all_reduce_mean,
    batch_sharding,
    local_device_count,
    make_mesh,
    mean_metrics,
    model_shard_params,
    rank_seed,
    replicated,
    shard_batch,
    shard_pytree,
    state_checksum,
    sync_grads,
)

__all__ = [
    "Mesh",
    "MeshSpec",
    "NamedSharding",
    "all_gather_cat",
    "all_reduce_mean",
    "batch_sharding",
    "local_device_count",
    "make_mesh",
    "mean_metrics",
    "model_shard_params",
    "rank_seed",
    "replicated",
    "shard_batch",
    "shard_pytree",
    "state_checksum",
    "sync_grads",
]
