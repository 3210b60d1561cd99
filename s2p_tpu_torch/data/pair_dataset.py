"""State–image pair dataset for S2P GAN training.

The port of ``s2p_tpu/data/pair_dataset.py``: (prev_image i_t, state
s_{t+1}, target_image i_{t+1}) triplets from the HDF5 the offline RL uses;
pairs never cross episode boundaries. Host numpy: uint8 NHWC frames and
float32 states. The trainer normalises uint8 to [-1, 1] on the device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from s2p_tpu_torch.data.hdf5 import load_rl_dataset


class S2PPairDataset:
    def __init__(
        self,
        prev_images: np.ndarray,  # [N, H, W, C] uint8  (i_t)
        states: np.ndarray,  # [N, S] float32          (s_{t+1})
        target_images: np.ndarray,  # [N, H, W, C] uint8 (i_{t+1})
        env_ids: Optional[np.ndarray] = None,  # [N] int32, 0-based env index
    ) -> None:
        if not len(prev_images) == len(states) == len(target_images):
            raise ValueError(f"pair arrays differ in length: {len(prev_images)}, "
                             f"{len(states)}, {len(target_images)}")
        self.prev_images = np.ascontiguousarray(prev_images, np.uint8)
        self.states = np.ascontiguousarray(states, np.float32)
        self.target_images = np.ascontiguousarray(target_images, np.uint8)
        if env_ids is None:
            env_ids = np.zeros(len(states), np.int32)
        if len(env_ids) != len(states):
            raise ValueError(f"env_ids has {len(env_ids)} rows, states {len(states)}")
        self.env_ids = np.ascontiguousarray(env_ids, np.int32)

    def __len__(self) -> int:
        return len(self.states)

    @property
    def state_dim(self) -> int:
        return self.states.shape[-1]

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return self.target_images.shape[1:]

    @classmethod
    def from_hdf5(cls, path: str, data_num: Optional[int] = None) -> "S2PPairDataset":
        """``path`` may be comma-separated for multi-env training; states are
        zero-padded to the widest env's dimension."""
        parts = [p for p in str(path).split(",") if p]
        if len(parts) > 1:
            return cls.concat([cls.from_hdf5(p, data_num) for p in parts])
        return cls.from_dataset(load_rl_dataset(parts[0], data_num))

    @classmethod
    def concat(cls, datasets: List["S2PPairDataset"]) -> "S2PPairDataset":
        if len({d.image_shape for d in datasets}) != 1:
            raise ValueError("multi-env training requires a common image size")
        sdim = max(d.state_dim for d in datasets)

        def pad(s: np.ndarray) -> np.ndarray:
            if s.shape[-1] == sdim:
                return s
            out = np.zeros((len(s), sdim), np.float32)
            out[:, : s.shape[-1]] = s
            return out

        return cls(
            np.concatenate([d.prev_images for d in datasets]),
            np.concatenate([pad(d.states) for d in datasets]),
            np.concatenate([d.target_images for d in datasets]),
            # env id = position in the dataroot list, for per-env eval columns
            np.concatenate([np.full(len(d), i, np.int32) for i, d in enumerate(datasets)]),
        )

    @classmethod
    def from_dataset(cls, ds: Dict[str, np.ndarray]) -> "S2PPairDataset":
        timeouts = np.asarray(ds["timeouts"]).ravel()
        if "image_observations_tp1" in ds:
            prev = ds["image_observations"]
            target = ds["image_observations_tp1"]
            states = ds["next_observations"]
            keep = np.ones(len(timeouts), bool)
        else:
            # consecutive-row pairing: (t, t+1) is a pair only when row t
            # does not end an episode
            prev = ds["image_observations"][:-1]
            target = ds["image_observations"][1:]
            states = ds["next_observations"][:-1]
            keep = timeouts[:-1] == 0
        return cls(prev[keep], states[keep], target[keep])

    def batches(self, batch_size: int, rng: np.random.RandomState,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of shuffled host batches."""
        order = rng.permutation(len(self))
        stop = len(self) - (len(self) % batch_size if drop_last else 0)
        for lo in range(0, stop, batch_size):
            idx = order[lo : lo + batch_size]
            yield dict(
                prev_image=self.prev_images[idx],
                state=self.states[idx],
                target_image=self.target_images[idx],
            )

    def eval_batch(self, start: int, n: int) -> Dict[str, np.ndarray]:
        sl = slice(start, start + n)
        return dict(
            prev_image=self.prev_images[sl],
            state=self.states[sl],
            target_image=self.target_images[sl],
        )

    @property
    def n_envs(self) -> int:
        return int(self.env_ids.max()) + 1 if len(self.env_ids) else 1

    def env_subset(self, env_id: int, n: Optional[int] = None) -> "S2PPairDataset":
        """The first ``n`` pairs of ``env_id`` (all when n is None): the
        concatenated dataset's head is the first dataroot alone."""
        idx = np.flatnonzero(self.env_ids == env_id)
        if n is not None:
            idx = idx[:n]
        return S2PPairDataset(self.prev_images[idx], self.states[idx],
                              self.target_images[idx], self.env_ids[idx])
