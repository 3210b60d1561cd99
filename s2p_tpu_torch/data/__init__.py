"""Datasets and replay buffers of the port (the port of ``s2p_tpu/data``):
the HDF5 schemas, the SLAC sequence and flat replay buffers, the pair
dataset, the env replay buffer and path loaders, the HER, multitask and
split buffers with the meta-RL loop, and the in-memory loaders."""

from s2p_tpu_torch.data.hdf5 import (
    load_augment_dataset,
    load_rl_dataset,
    load_state_dataset,
    make_slac_window_indices,
    save_dataset,
)
from s2p_tpu_torch.data.replay import SimpleReplayBuffer, SlacReplayBuffer
from s2p_tpu_torch.data.pair_dataset import S2PPairDataset
from s2p_tpu_torch.data.env_replay_buffer import (
    EnvReplayBuffer,
    FixedNormalizer,
    Normalizer,
    PathBuilder,
)
from s2p_tpu_torch.data.her_buffer import ObsDictRelabelingBuffer
from s2p_tpu_torch.data.multitask_buffer import (
    MetaRLAlgorithm,
    MultiTaskReplayBuffer,
    SplitReplayBuffer,
)
from s2p_tpu_torch.data.path_loaders import DictToMDPPathLoader, HDF5PathLoader, load_hdf5
from s2p_tpu_torch.data.loaders import (
    ImageDataset,
    batch_iterator,
    conv2d_output_size,
    conv_stack_output_shape,
    conv_transpose2d_output_size,
    infinite_random_sampler,
)

__all__ = [
    "load_rl_dataset",
    "load_state_dataset",
    "load_augment_dataset",
    "save_dataset",
    "make_slac_window_indices",
    "SlacReplayBuffer",
    "SimpleReplayBuffer",
    "S2PPairDataset",
    "EnvReplayBuffer",
    "FixedNormalizer",
    "Normalizer",
    "PathBuilder",
    "ObsDictRelabelingBuffer",
    "MetaRLAlgorithm",
    "MultiTaskReplayBuffer",
    "SplitReplayBuffer",
    "DictToMDPPathLoader",
    "HDF5PathLoader",
    "load_hdf5",
    "ImageDataset",
    "batch_iterator",
    "conv2d_output_size",
    "conv_stack_output_shape",
    "conv_transpose2d_output_size",
    "infinite_random_sampler",
]
