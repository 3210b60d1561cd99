"""``state_transition_rollout`` — the world model's synthetic transitions.

The port of the root ``state_transition_rollout.py``, with the same flags:

    python -m s2p_tpu_torch.cli.state_transition_rollout --dataset real.hdf5 \
        --output all_state_1step_random_action_dataset_augment.hdf5 --gpu_ids=0

Reads an image-RL dataset, loads (``--model``) or trains (``--train_steps``
Adam steps at batch min(256, N)) an ensemble, and writes the augment
dataset of ``world_model.generate_augmented_dataset``. ``--model`` takes a
torch state dict (``.pth`` or any torch zip file; the reference's
``saved_*`` elite snapshot is dropped) or a pickled JAX parameter tree with
numpy leaves.

``--gpu_ids``: ``0`` (the default) runs on ``cuda:0``, ``-1`` on the CPU.
Without CUDA any id other than -1 is an error.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
from typing import Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True, help="image-RL HDF5 (the real dataset's schema)")
    p.add_argument("--model", default=None,
                   help="ensemble checkpoint: a torch state dict (.pth/.pkl zip) or a pickled "
                        "JAX parameter tree with numpy leaves; omit to train a fresh ensemble")
    p.add_argument("--normalize_configs", default=None,
                   help="normalize_configs_dict.pkl; omit to compute from data")
    p.add_argument("--output", default="all_state_1step_random_action_dataset_augment.hdf5")
    p.add_argument("--action_low", type=float, default=-1.0)
    p.add_argument("--action_high", type=float, default=1.0)
    p.add_argument("--ensemble_size", type=int, default=7)
    p.add_argument("--hidden_features", type=int, default=256)
    p.add_argument("--hidden_layers", type=int, default=3)
    p.add_argument("--train_steps", type=int, default=2000,
                   help="used only when --model is omitted")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_sequences", type=int, default=8)
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="CUDA device index (first of a comma list); -1 runs on the CPU")
    return p


def _looks_torch(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"PK"  # torch's zip serialization


def load_ensemble_state_dict(path: str) -> dict:
    """The port's state dict from a torch file or a pickled JAX tree."""
    from s2p_tpu_torch.gan.convert import load_pth
    from s2p_tpu_torch.utils.checkpoint import load_numpy_pickle
    from s2p_tpu_torch.world_model import split_saved, state_dict_from_jax_ensemble_params

    if path.endswith(".pth") or _looks_torch(path):
        sd, _ = split_saved(load_pth(path))
        return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    return state_dict_from_jax_ensemble_params(load_numpy_pickle(path))


def ensemble_training_arrays(ds: dict, normalization: dict) -> tuple:
    """(x, y) float32: normalized (obs ‖ act) and (next_obs ‖ reward)."""
    x = np.concatenate([
        (ds["observations"] - normalization["obs_mean"]) / normalization["obs_std"],
        ds["actions"],
    ], axis=-1).astype(np.float32)
    y = np.concatenate([
        (ds["next_observations"] - normalization["next_obs_mean"]) / normalization["next_obs_std"],
        ((ds["rewards"] - normalization["reward_mean"]) / normalization["reward_std"])[:, None],
    ], axis=-1).astype(np.float32)
    return x, y


def train_ensemble(model, ds: dict, normalization: dict, steps: int, seed: int) -> list:
    """``steps`` Adam NLL steps on ``ensemble_training_arrays`` at batch
    min(256, N); the rows of each batch come from
    ``RandomState(seed).randint``. The normalized data is uploaded once;
    each step uploads only its indices. Returns the (step, loss) pairs it
    printed, every 500 steps."""
    from s2p_tpu_torch.world_model import make_ensemble_train_step

    device = next(model.parameters()).device
    x, y = ensemble_training_arrays(ds, normalization)
    x_dev, y_dev = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    step = make_ensemble_train_step(model)
    rs = np.random.RandomState(seed)
    bs = min(256, len(x))
    history = []
    for i in range(steps):
        idx = torch.from_numpy(rs.randint(0, len(x), bs)).to(device)
        loss = step(x_dev[idx], y_dev[idx])
        if i % 500 == 0:
            history.append((i, float(loss)))
            print(f"ensemble step {i}: nll {history[-1][1]:.4f}")
    return history


def main(argv: Optional[list] = None) -> str:
    args = build_parser().parse_args(argv)
    from s2p_tpu_torch.cli.simple_test import resolve_device

    device = resolve_device(args.gpu_ids)

    from s2p_tpu_torch.data.hdf5 import load_rl_dataset, save_dataset
    from s2p_tpu_torch.world_model import (
        EnsembleTransition,
        compute_normalization,
        generate_augmented_dataset,
    )

    ds = load_rl_dataset(args.dataset)
    obs_dim, act_dim = ds["observations"].shape[1], ds["actions"].shape[1]
    model = EnsembleTransition(obs_dim, act_dim, hidden_features=args.hidden_features,
                               hidden_layers=args.hidden_layers,
                               ensemble_size=args.ensemble_size, seed=args.seed, device=device)
    if args.normalize_configs:
        with open(args.normalize_configs, "rb") as f:
            normalization = pickle.load(f)
    else:
        normalization = compute_normalization(ds)

    if args.model:
        model.load_state_dict(load_ensemble_state_dict(args.model), strict=True)
    else:
        train_ensemble(model, ds, normalization, args.train_steps, args.seed)

    out = generate_augmented_dataset(
        ds, model, normalization, action_low=np.full(act_dim, args.action_low),
        action_high=np.full(act_dim, args.action_high), num_sequences=args.num_sequences,
        seed=args.seed)
    os.makedirs(osp.dirname(osp.abspath(args.output)), exist_ok=True)
    save_dataset(args.output, out)
    print(f"wrote {len(out['actions'])} augmented transitions to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
