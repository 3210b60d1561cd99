"""``final_eval`` — multi-path evaluation of an RL snapshot.

The port of ``s2p_tpu/cli/final_eval.py``, with the same flags and
``--gpu_id``:

    python -m s2p_tpu_torch.cli.final_eval --run_dir logs/iql_image/RUN \
        --snapshot best --n_paths 5 --gpu_id 0

The training loop's eval is one path per epoch; this replays a snapshot
for N full episodes with the deterministic policy over the SLAC
feature_action and prints the mean, std, min and max return, the per-path
returns and, with ``--fallen_threshold``, the fallen-mode rate. The
snapshot is an ``itr_N.pkl`` or ``params.pkl`` of numpy trees under flax
names (``latent_params``, ``policy_params``), as the port's loop and the
JAX package's write them; ``--snapshot best`` picks the ``itr_N.pkl`` of
the highest fresh logged eval return in ``progress.csv``.

``--gpu_id``: ``0`` (the default) runs on ``cuda:0``, ``-1`` on the CPU;
without CUDA any id other than -1 is an error.
"""

import argparse
import csv
import glob
import os.path as osp

import numpy as np


def select_best_snapshot(run_dir: str) -> str:
    """Pick the itr_N.pkl with the highest FRESH logged eval return.

    Reads ``progress.csv`` (frozen-key contract), keeps rows where
    ``eval/is_fresh`` is 1 (when the column exists — carried-forward eval
    rows repeat a stale number), and returns the snapshot path for the
    best epoch that actually has an ``itr_{epoch}.pkl`` on disk.
    """
    csv_path = osp.join(run_dir, "progress.csv")
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"empty progress.csv in {run_dir}")
    ret_key = "eval/Returns Mean"
    if ret_key not in rows[0]:
        raise ValueError(f"{csv_path} has no '{ret_key}' column")
    best = None  # (return, epoch, path)
    for row in rows:
        fresh = row.get("eval/is_fresh")
        if fresh is not None and float(fresh) != 1.0:
            continue
        epoch = int(float(row["epoch"]))
        snap = osp.join(run_dir, f"itr_{epoch}.pkl")
        if not osp.exists(snap):
            continue
        ret = float(row[ret_key])
        if best is None or ret > best[0]:
            best = (ret, epoch, snap)
    if best is None:
        raise ValueError(
            f"no snapshot-bearing fresh-eval epoch found in {run_dir}"
        )
    print(f"best snapshot: epoch {best[1]} (logged eval return {best[0]:.1f})")
    return best[2]


def resolve_snapshot(run_dir: str, snapshot: str) -> str:
    """Resolve ``--snapshot`` to a file: 'best' → highest fresh logged
    eval, 'final' → params.pkl (the final-epoch params), else a
    filename/glob under ``run_dir``."""
    if snapshot == "best":
        return select_best_snapshot(run_dir)
    pattern = "params.pkl" if snapshot == "final" else snapshot
    hits = glob.glob(f"{run_dir}/{pattern}")
    if not hits:
        raise FileNotFoundError(
            f"no snapshot matching {pattern!r} under {run_dir}"
        )
    return hits[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--env_name", default="cheetah-run")
    ap.add_argument("--snapshot", default="params.pkl",
                    help="snapshot filename/glob under run_dir, 'final' "
                         "(alias for params.pkl — the final-epoch params), "
                         "or 'best' to pick the itr_N.pkl with the highest "
                         "fresh logged eval return in progress.csv")
    ap.add_argument("--n_paths", type=int, default=5)
    ap.add_argument("--image_size", type=int, default=100)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--fallen_threshold", type=float, default=None,
                    help="returns below this count as 'fallen mode' "
                         "episodes; adds a fallen-rate line (walker-walk "
                         "deterministic eval occasionally lands in a "
                         "fallen attractor — report the rate, don't hide "
                         "it in the std)")
    ap.add_argument("--gpu_id", type=int, default=0, help="CUDA device index; -1 runs on the CPU")
    args = ap.parse_args(argv)

    from s2p_tpu_torch.cli.simple_test import resolve_device

    device = resolve_device(str(args.gpu_id), flag="--gpu_id")

    from s2p_tpu_torch.envs import make_dmc
    from s2p_tpu_torch.rl import TanhGaussianPolicy
    from s2p_tpu_torch.samplers import MdpPathCollector, PolicyAgent
    from s2p_tpu_torch.slac import SlacAlgorithm, state_dict_from_jax_latent_params
    from s2p_tpu_torch.utils.checkpoint import load_numpy_pickle

    path = resolve_snapshot(args.run_dir, args.snapshot)
    snap = load_numpy_pickle(path)

    env = make_dmc(args.env_name, from_pixels=True, height=args.image_size,
                   width=args.image_size, seed=args.seed)
    action_dim = env.action_space.shape[0]
    slac = SlacAlgorithm(action_dim=action_dim, num_sequences=8, buffer_size=1000,
                         feature_dim=256, z1_dim=32, z2_dim=256, image_size=args.image_size,
                         seed=args.seed, device=device)
    slac.latent.load_state_dict(state_dict_from_jax_latent_params(snap["latent_params"]),
                                strict=True)
    policy = TanhGaussianPolicy(slac.feature_action_dim, (1024, 1024), action_dim).to(device)
    agent = PolicyAgent(policy, snap["policy_params"], deterministic=True, seed=args.seed)
    col = MdpPathCollector(env, agent, slac_algo=slac, slac_policy_input_type="feature_action")
    horizon = env._max_episode_steps
    paths = col.collect_new_paths(horizon, args.n_paths * horizon,
                                  discard_incomplete_paths=True)
    rets = [float(np.sum(p["rewards"])) for p in paths]
    print(f"{args.env_name} {osp.basename(path)}: n={len(rets)} "
          f"return mean {np.mean(rets):.1f} std {np.std(rets):.1f} "
          f"min {np.min(rets):.1f} max {np.max(rets):.1f}")
    print("per-path returns: " + " ".join(f"{r:.1f}" for r in rets))
    if args.fallen_threshold is not None:
        fallen = sum(r < args.fallen_threshold for r in rets)
        print(f"fallen-mode rate (< {args.fallen_threshold:.0f}): "
              f"{fallen}/{len(rets)} = {fallen / max(len(rets), 1):.2f}")
    return rets


if __name__ == "__main__":
    main()
