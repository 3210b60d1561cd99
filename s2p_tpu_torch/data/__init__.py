from s2p_tpu_torch.data.hdf5 import load_rl_dataset

__all__ = ["load_rl_dataset"]
