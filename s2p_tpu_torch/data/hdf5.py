"""HDF5 dataset IO: the two dataset schemas of the S2P pipeline.

The port of ``s2p_tpu/data/hdf5.py``:

1. the **image-RL dataset** (``load_rl_dataset``): per-transition
   ``observations/actions/rewards/next_observations``, the single-frame
   ``image_observations`` (NHWC uint8, kept as stored) and the ``timeouts``
   episode delimiters, plus the optional keys when present; and its
   state-only form (``load_state_dataset``);
2. the **augmented dataset** (``load_augment_dataset``) that the world
   model writes: ensemble actions/rewards/next_observations, the
   ``original_*`` columns, the two uncertainties and the SLAC window
   indices, with ``SENTINEL`` on the first ``num_sequences`` steps of each
   trajectory; the S2P generator later adds ``image_observations_tp1``.

``h5py`` is imported when a file is read or written, so the rest of the
package runs where it is not installed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

SENTINEL = int(1e9)  # the window index of a step with no full window behind it

RL_KEYS = (
    "observations",
    "actions",
    "rewards",
    "next_observations",
    "image_observations",
    "timeouts",
)
RL_OPTIONAL = (
    "terminals",
    "image_observations_tm1",
    "image_observations_tm2",
    "image_observations_tp1",
    "qpos_qvel",
)
STATE_KEYS = (
    "observations",
    "actions",
    "rewards",
    "next_observations",
    "timeouts",
)
AUG_KEYS = (
    "observations",
    "actions",
    "rewards",
    "next_observations",
    "timeouts",
    "original_actions",
    "original_rewards",
    "slac_observation_indices",
    "slac_action_indices",
    "disagreement_uncertainty",
    "aleatoric_uncertainty",
)
AUG_OPTIONAL = ("image_observations", "image_observations_tp1", "qpos_qvel")


def make_slac_window_indices(traj_length: int, traj_start_idx: int,
                             num_sequences: int = 8) -> tuple:
    """SLAC's (num_sequences + 1)-frame and num_sequences-action window
    indices ``[T, num_sequences + 1]`` and ``[T, num_sequences]`` (int64) of
    one trajectory that starts at row ``traj_start_idx``; the first
    ``num_sequences`` steps get ``SENTINEL``."""
    if traj_length <= num_sequences:
        raise ValueError(f"traj length {traj_length} must exceed num_sequences {num_sequences}")
    steps = np.arange(traj_length)[:, None]
    obs = steps - num_sequences + np.arange(num_sequences + 1)[None, :] + traj_start_idx
    act = obs[:, :-1].copy()
    invalid = steps[:, 0] < num_sequences
    obs[invalid] = SENTINEL
    act[invalid] = SENTINEL
    return obs.astype(np.int64), act.astype(np.int64)


def episode_slices(timeouts: np.ndarray) -> List[slice]:
    """The row slices of a flat dataset's episodes, each ending at a
    ``timeouts == 1`` row (rows after the last such row belong to none)."""
    ends = np.sort(np.where(np.asarray(timeouts).ravel() == 1)[0])
    out, start = [], 0
    for e in ends:
        out.append(slice(start, int(e) + 1))
        start = int(e) + 1
    return out


def _load(path: str, keys: Sequence[str], optional: Sequence[str],
          data_num: Optional[int]) -> Dict[str, np.ndarray]:
    """Read the required and any optional keys (the first ``data_num`` rows,
    or all); 2-D ``[N, 1]`` rewards and original rewards are squeezed to
    ``[N]``."""
    import h5py

    out: Dict[str, np.ndarray] = {}
    sl = slice(None) if data_num is None else slice(data_num)
    with h5py.File(path, "r") as f:
        for k in keys:
            if k not in f:
                raise KeyError(f"{path} missing required dataset {k!r}")
            out[k] = f[k][sl]
        for k in optional:
            if k in f:
                out[k] = f[k][sl]
    for k in ("rewards", "original_rewards"):
        if k in out and out[k].ndim == 2 and out[k].shape[1] == 1:
            out[k] = out[k].squeeze(-1)
    return out


def load_rl_dataset(path: str, data_num: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The image-RL dataset (the generation and rollout CLIs' input)."""
    return _load(path, RL_KEYS, RL_OPTIONAL, data_num)


def load_state_dataset(path: str, data_num: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A state-only dataset: images are read when present, not required."""
    return _load(path, STATE_KEYS, ("image_observations",) + RL_OPTIONAL, data_num)


def load_augment_dataset(path: str, data_num: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The world model's augmented dataset (the image bridge's input)."""
    return _load(path, AUG_KEYS, AUG_OPTIONAL, data_num)


def save_dataset(path: str, dataset: Dict[str, np.ndarray]) -> None:
    """Write every entry of ``dataset`` as one HDF5 dataset of its name."""
    import h5py

    with h5py.File(path, "w") as f:
        for k, v in dataset.items():
            f.create_dataset(str(k), data=np.asarray(v))


def make_synthetic_rl_dataset(n_episodes: int = 3, episode_len: int = 20, obs_dim: int = 17,
                              act_dim: int = 6, img_hw: int = 16, seed: int = 0,
                              with_tp1: bool = True) -> Dict[str, np.ndarray]:
    """A small, schema-faithful stand-in for the real image-RL dataset,
    drawn from ``np.random.RandomState(seed)`` in the JAX package's order,
    so both packages make the same rows from one seed."""
    rng = np.random.RandomState(seed)
    n = n_episodes * episode_len
    timeouts = np.zeros(n, np.float32)
    timeouts[episode_len - 1::episode_len] = 1.0
    imgs = rng.randint(0, 256, size=(n, img_hw, img_hw, 3), dtype=np.uint8)
    ds = dict(
        observations=rng.randn(n, obs_dim).astype(np.float32),
        actions=rng.uniform(-1, 1, size=(n, act_dim)).astype(np.float32),
        rewards=rng.rand(n).astype(np.float32),
        next_observations=rng.randn(n, obs_dim).astype(np.float32),
        terminals=np.zeros(n, np.float32),
        timeouts=timeouts,
        image_observations=imgs,
    )
    if with_tp1:
        # the next frame is the following row's; the last row repeats its own
        ds["image_observations_tp1"] = np.concatenate([imgs[1:], imgs[-1:]], axis=0).copy()
    return ds
