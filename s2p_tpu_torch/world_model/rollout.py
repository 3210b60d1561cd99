"""Synthetic state-transition datasets from the ensemble ("extended
distribution").

The port of ``s2p_tpu/world_model/rollout.py``. For every row of a real
dataset: draw a uniform random action, predict (next_obs, reward) with one
random ensemble member per row, record the members' disagreement and the
aleatoric spread, attach the SLAC window indices (``SENTINEL`` for the first
``num_sequences`` steps of each trajectory) and return the augment schema
that ``data/hdf5.py::load_augment_dataset`` reads.

The host draws every random number with ``np.random.RandomState(seed)`` in
the JAX package's order, so both packages give the same actions, members
and windows from one seed. The ensemble forward, the member gather and the
uncertainty reductions run on the model's device in chunks whose outputs
stay there until the last chunk is dispatched and then come back at once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from s2p_tpu_torch.data.hdf5 import episode_slices, make_slac_window_indices
from s2p_tpu_torch.world_model.ensemble import EnsembleTransition


def compute_normalization(dataset: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Mean and std (+1e-8) of observations, next observations and rewards,
    computed in float64 and stored as float32."""
    out = {}
    for key, name in (("observations", "obs"), ("next_observations", "next_obs"),
                      ("rewards", "reward")):
        v = np.asarray(dataset[key], np.float64)
        out[f"{name}_mean"] = v.mean(axis=0).astype(np.float32)
        out[f"{name}_std"] = (v.std(axis=0) + 1e-8).astype(np.float32)
    return out


@torch.no_grad()
def _predict(model: EnsembleTransition, norm_obs: torch.Tensor, actions: torch.Tensor,
             member_idx: torch.Tensor):
    """(the chosen member's normalized next obs ``[B, obs]`` and reward
    ``[B]``, the disagreement ``[B, 1]``: max over members of ‖μ_e − mean_e
    μ‖ on the observation part, the aleatoric term ``[B, 1]``: max over
    members of ‖σ‖ on the whole output)."""
    mu, std = model(torch.cat([norm_obs, actions], dim=-1))
    batch = torch.arange(mu.shape[1], device=mu.device)
    sel_obs = mu[member_idx, batch, :model.obs_dim]
    sel_rew = mu[member_idx, batch, -1]
    obs_modes = mu[:, :, :-1]
    diff = obs_modes - obs_modes.mean(dim=0)
    disagreement = torch.linalg.vector_norm(diff, dim=-1, keepdim=True).amax(dim=0)
    aleatoric = torch.linalg.vector_norm(std, dim=-1, keepdim=True).amax(dim=0)
    return sel_obs, sel_rew, disagreement, aleatoric


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def generate_augmented_dataset(dataset: Dict[str, np.ndarray], model: EnsembleTransition,
                               normalization: Dict[str, np.ndarray], action_low: np.ndarray,
                               action_high: np.ndarray, num_sequences: int = 8, seed: int = 0,
                               chunk: int = 65536) -> Dict[str, np.ndarray]:
    """The augment-schema dataset: ``dataset``'s columns, with actions,
    rewards and next observations from the ensemble, the originals under
    ``original_actions``/``original_rewards``, both uncertainties and the
    SLAC window indices."""
    rng = np.random.RandomState(seed)
    obs = np.asarray(dataset["observations"], np.float32)
    n = len(obs)
    act_dim = len(np.asarray(action_low).ravel())
    timeouts = np.asarray(dataset["timeouts"]).ravel()
    if not (np.asarray(dataset.get("terminals", np.zeros(n))) == 0).all():
        raise ValueError("the rollout assumes no terminal states")

    norm_obs = (obs - normalization["obs_mean"]) / normalization["obs_std"]
    actions = rng.uniform(low=action_low, high=action_high, size=(n, act_dim)).astype(np.float32)
    member_idx = rng.randint(0, model.ensemble_size, size=n)

    device = _device_of(model)
    outs = []
    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        outs.append(_predict(model, torch.from_numpy(norm_obs[sl]).to(device),
                             torch.from_numpy(actions[sl]).to(device),
                             torch.from_numpy(member_idx[sl]).to(device)))
    sel_obs, sel_rew, dis, ale = (torch.cat(parts).cpu().numpy() for parts in zip(*outs))

    next_obs = sel_obs * normalization["next_obs_std"] + normalization["next_obs_mean"]
    rewards = sel_rew * normalization["reward_std"] + normalization["reward_mean"]

    windows = [make_slac_window_indices(sl.stop - sl.start, sl.start, num_sequences)
               for sl in episode_slices(timeouts)]
    out = dict(dataset)
    out["original_actions"] = np.asarray(dataset["actions"])
    out["original_rewards"] = np.asarray(dataset["rewards"])
    out["actions"] = actions
    out["rewards"] = rewards.astype(np.float32)
    out["next_observations"] = next_obs.astype(np.float32)
    out["disagreement_uncertainty"] = dis.astype(np.float32)
    out["aleatoric_uncertainty"] = ale.astype(np.float32)
    out["slac_observation_indices"] = np.concatenate([o for o, _ in windows], axis=0)
    out["slac_action_indices"] = np.concatenate([a for _, a in windows], axis=0)
    return out


def generate_multistep_dataset(dataset: Dict[str, np.ndarray], model: EnsembleTransition,
                               normalization: Dict[str, np.ndarray], action_low: np.ndarray,
                               action_high: np.ndarray, horizon: int = 5,
                               n_starts: Optional[int] = None,
                               action_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                               seed: int = 0) -> Dict[str, np.ndarray]:
    """Multi-step rollouts: from ``n_starts`` random dataset states, roll
    the ensemble ``horizon`` steps with uniform random actions (or
    ``action_fn(obs) → actions``), one random member per (row, step). Rows
    come back trajectory-major (rollout i holds rows [i·horizon,
    (i+1)·horizon)), with ``timeouts`` on each rollout's last row; a
    starting frame, when the dataset has images, is repeated over its
    rollout. Each step's state comes back to the host, where the next
    step's actions are drawn (and ``action_fn`` runs)."""
    rng = np.random.RandomState(seed)
    obs_all = np.asarray(dataset["observations"], np.float32)
    n_rows = len(obs_all)
    act_dim = len(np.asarray(action_low).ravel())
    n_starts = n_starts or n_rows
    starts = rng.randint(0, n_rows, n_starts)
    device = _device_of(model)

    cur = obs_all[starts]
    rows = {k: [] for k in ("obs", "act", "rew", "next", "dis", "ale")}
    for _ in range(horizon):
        norm_obs = (cur - normalization["obs_mean"]) / normalization["obs_std"]
        if action_fn is not None:
            actions = np.asarray(action_fn(cur), np.float32)
        else:
            actions = rng.uniform(action_low, action_high, (n_starts, act_dim)).astype(np.float32)
        member = rng.randint(0, model.ensemble_size, n_starts)
        sel_obs, sel_rew, dis, ale = (t.cpu().numpy() for t in _predict(
            model, torch.from_numpy(norm_obs).to(device), torch.from_numpy(actions).to(device),
            torch.from_numpy(member).to(device)))
        nxt = (sel_obs * normalization["next_obs_std"] + normalization["next_obs_mean"])
        rew = sel_rew * normalization["reward_std"] + normalization["reward_mean"]
        rows["obs"].append(cur)
        rows["act"].append(actions)
        rows["rew"].append(rew.astype(np.float32))
        rows["next"].append(nxt.astype(np.float32))
        rows["dis"].append(dis)
        rows["ale"].append(ale)
        cur = nxt.astype(np.float32)

    def stack(key):
        return np.stack(rows[key], axis=1).reshape(n_starts * horizon, -1)

    timeouts = np.zeros(n_starts * horizon, np.float32)
    timeouts[horizon - 1::horizon] = 1.0
    out = dict(
        observations=stack("obs"),
        actions=stack("act"),
        rewards=stack("rew").ravel(),
        next_observations=stack("next"),
        timeouts=timeouts,
        disagreement_uncertainty=stack("dis").astype(np.float32),
        aleatoric_uncertainty=stack("ale").astype(np.float32),
    )
    if "image_observations" in dataset:
        imgs = np.asarray(dataset["image_observations"])[starts]
        out["image_observations"] = np.repeat(imgs, horizon, axis=0)
    return out
