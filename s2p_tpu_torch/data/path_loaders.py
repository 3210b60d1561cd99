"""Demonstration path loaders: the port of ``s2p_tpu/data/path_loaders.py``
(plain numpy).

``load_hdf5``/``HDF5PathLoader`` (rlkit's ``hdf5_path_loader.py``) fill a
replay buffer row by row from a D4RL-style dataset (observations, actions,
rewards, terminals, next_observations), with optional observation
preprocessing; ``DictToMDPPathLoader`` from pickled path dicts.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np


def load_hdf5(dataset: Dict[str, np.ndarray], replay_buffer) -> int:
    """Row-wise bulk fill (reference hdf5_path_loader.py:28-44)."""
    n = len(dataset["observations"])
    rewards = np.asarray(dataset["rewards"]).reshape(n, -1)[:, 0]
    terminals = np.asarray(
        dataset.get("terminals", np.zeros(n))
    ).reshape(n, -1)[:, 0]
    for i in range(n):
        replay_buffer.add_sample(
            dataset["observations"][i],
            dataset["actions"][i],
            rewards[i],
            terminals[i],
            dataset["next_observations"][i],
        )
    return n


class HDF5PathLoader:
    """Load D4RL-style HDF5 demo data into buffers
    (reference hdf5_path_loader.py:46+)."""

    def __init__(
        self,
        trainer,
        replay_buffer,
        demo_train_buffer=None,
        demo_test_buffer=None,
        obs_key: str = "observations",
        obs_preprocessor: Optional[Callable] = None,
    ):
        self.trainer = trainer
        self.replay_buffer = replay_buffer
        self.demo_train_buffer = demo_train_buffer
        self.demo_test_buffer = demo_test_buffer
        self.obs_key = obs_key
        self.obs_preprocessor = obs_preprocessor

    def load_path(self, dataset: Dict[str, np.ndarray]) -> int:
        if self.obs_preprocessor is not None:
            dataset = dict(dataset)
            dataset["observations"] = self.obs_preprocessor(dataset["observations"])
            dataset["next_observations"] = self.obs_preprocessor(
                dataset["next_observations"]
            )
        return load_hdf5(dataset, self.replay_buffer)

    def load_demos(self, datasets: Sequence[Dict[str, np.ndarray]]) -> int:
        return sum(self.load_path(d) for d in datasets)


class DictToMDPPathLoader:
    """Load pickled path dicts (lists of per-path dicts) into buffers
    (reference dict_to_mdp_path_loader.py)."""

    def __init__(
        self,
        replay_buffer,
        demo_paths: Sequence[Any] = (),
        obs_key: str = "observations",
        action_key: str = "actions",
        reward_scale: float = 1.0,
    ):
        self.replay_buffer = replay_buffer
        self.demo_paths = list(demo_paths)
        self.obs_key = obs_key
        self.action_key = action_key
        self.reward_scale = reward_scale

    def load_path(self, path: Dict[str, Any]) -> int:
        obs = np.asarray(path[self.obs_key])
        acts = np.asarray(path[self.action_key])
        rewards = np.asarray(path["rewards"]).reshape(len(obs), -1)[:, 0]
        terminals = np.asarray(
            path.get("terminals", np.zeros(len(obs)))
        ).reshape(len(obs), -1)[:, 0]
        next_obs = np.asarray(
            path.get("next_observations", np.concatenate([obs[1:], obs[-1:]]))
        )
        for i in range(len(obs)):
            self.replay_buffer.add_sample(
                obs[i], acts[i], self.reward_scale * rewards[i],
                terminals[i], next_obs[i],
            )
        return len(obs)

    def load_demos(self) -> int:
        return sum(self.load_path(p) for p in self.demo_paths)
