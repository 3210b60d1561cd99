"""``collect_dataset`` — collect an offline state dataset with online SAC,
the pipeline's front end.

The port of the root ``collect_dataset.py``, with the same flags and
``--gpu_ids``:

    python -m s2p_tpu_torch.cli.collect_dataset --env_name cheetah-run \
        --num_steps 100000 --output state_dataset.hdf5 --gpu_ids=0

Trains SAC (policy and critic 256 × 2) on a DeepMind Control env: random
actions for the first ``--start_random_steps`` steps, then the policy's,
with one SAC step on a ``--batch_size`` batch of the replay buffer every
``--train_every`` steps from then on. Every transition is recorded
(observations, actions, rewards, next_observations, terminals, timeouts)
with the simulator's ``qpos_qvel`` before the step, which
``image_render`` replays to render the frames, and the state dataset is
written to ``--output`` as HDF5.

``--gpu_ids``: ``0`` (the default) trains on ``cuda:0``, ``-1`` on the
CPU; without CUDA any id other than -1 is an error.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

RECORD_KEYS = ("observations", "actions", "rewards", "next_observations", "terminals",
               "timeouts", "qpos_qvel")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env_name", default="cheetah-run")
    p.add_argument("--num_steps", type=int, default=100_000)
    p.add_argument("--start_random_steps", type=int, default=1_000)
    p.add_argument("--train_every", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--buffer_size", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="state_dataset.hdf5")
    p.add_argument("--log_interval", type=int, default=1_000)
    p.add_argument("--target_entropy", type=float, default=None,
                   help="SAC auto-alpha target entropy (default -|A|). "
                        "Raise (e.g. -|A|/2) for a higher-entropy dataset "
                        "with less action saturation — CQL's BC warmup "
                        "degenerates on bang-bang datasets")
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="CUDA device index (first of a comma list); -1 runs on the CPU")
    return p


def collect(env, args: argparse.Namespace, device: torch.device) -> Dict[str, np.ndarray]:
    """Train SAC on ``env`` for ``args.num_steps`` env steps (the flags of
    ``build_parser``) on ``device``, recording every transition; returns
    the dataset as float32 arrays. ``env`` has the gym-classic API, an
    ``action_space`` that samples, and ``physics.data.qpos``/``qvel``."""
    from s2p_tpu_torch.data.env_replay_buffer import EnvReplayBuffer
    from s2p_tpu_torch.rl import CriticSLAC, SACTrainer, TanhGaussianPolicy
    from s2p_tpu_torch.samplers import PolicyAgent

    obs_dim = env.observation_space.shape[0]
    act_dim = env.action_space.shape[0]
    trainer = SACTrainer(TanhGaussianPolicy(obs_dim, (256, 256), act_dim, seed=args.seed),
                         CriticSLAC(obs_dim, act_dim, (256, 256), seed=args.seed + 1),
                         seed=args.seed, target_entropy=args.target_entropy, device=device)
    agent = PolicyAgent(trainer.policy, seed=args.seed)  # acts with the current weights
    buf = EnvReplayBuffer(args.buffer_size, env, device=device)

    rec = {k: [] for k in RECORD_KEYS}
    o = env.reset()
    ep_return, returns = 0.0, []
    for t in range(args.num_steps):
        qq = np.concatenate([env.physics.data.qpos, env.physics.data.qvel])
        if t < args.start_random_steps:
            a = env.action_space.sample()
        else:
            a, _ = agent.get_action(o)
        next_o, r, done, info = env.step(a)
        truncated = info.get("TimeLimit.truncated", False)
        rec["observations"].append(o)
        rec["actions"].append(a)
        rec["rewards"].append(r)
        rec["next_observations"].append(next_o)
        rec["terminals"].append(float(done and not truncated))
        rec["timeouts"].append(float(truncated))
        rec["qpos_qvel"].append(qq)
        buf.add_sample(o, a, r, float(done and not truncated), next_o)
        ep_return += r

        if done:
            returns.append(ep_return)
            ep_return = 0.0
            o = env.reset()
        else:
            o = next_o

        if t >= args.start_random_steps and t % args.train_every == 0:
            trainer.train(buf.random_batch(args.batch_size))
        if args.log_interval and (t + 1) % args.log_interval == 0:
            avg = np.mean(returns[-5:]) if returns else float("nan")
            print(f"step {t + 1}/{args.num_steps}  recent return {avg:.1f}")

    return {k: np.asarray(v, np.float32) for k, v in rec.items()}


def main(argv: Optional[list] = None) -> str:
    args = build_parser().parse_args(argv)
    from s2p_tpu_torch.cli.simple_test import resolve_device

    device = resolve_device(args.gpu_ids)

    from s2p_tpu_torch.data.hdf5 import save_dataset
    from s2p_tpu_torch.envs import make_dmc
    from s2p_tpu_torch.utils.seeding import set_seed

    set_seed(args.seed)
    env = make_dmc(args.env_name, from_pixels=False, seed=args.seed)
    ds = collect(env, args, device)
    save_dataset(args.output, ds)
    print(f"wrote {len(ds['actions'])} transitions to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
