"""``simple_test`` — N-step autoregressive S2P generation on the card.

The port of ``s2p_tpu/cli/simple_test.py``, with the same flags and the
same PNG outputs:

    python -m s2p_tpu_torch.cli.simple_test --env_type=cheetah \
        --dataroot=./datasets --netG=s2p --start_idx=0 --seq_len=5 --gpu_ids=0

Take the ground-truth image i_{t0} at ``--start_idx`` and the states
s_{t0+1..t0+L}, generate i_{t+1} = G(s_{t+1}, î_t) for ``--seq_len`` steps,
and save the frames (with the ground-truth strip when available) as PNGs.

``--gpu_ids``: ``0`` (the default) runs on ``cuda:0``, ``-1`` on the CPU
(the SPADE/pix2pixHD convention). Without CUDA any id other than -1 is an
error; the CLI never falls back to the CPU on its own.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional

import numpy as np
import torch

ENV_DEFAULTS = {
    # env_type -> (image_size, default seq_len)
    "cheetah": (64, 5),
    "walker": (64, 10),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env_type", type=str, default="cheetah", choices=sorted(ENV_DEFAULTS))
    p.add_argument("--dataroot", type=str, default="./datasets",
                   help="HDF5 file or directory containing {env_type}.hdf5")
    p.add_argument("--netG", type=str, default="s2p",
                   choices=["s2p", "sat_state", "sat_image"])
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--seq_len", type=int, default=None,
                   help="default: 5 (cheetah) / 10 (walker)")
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="CUDA device index (first of a comma list); -1 runs on the CPU")
    p.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
    p.add_argument("--which_epoch", type=str, default="30",
                   help="loads {env_type}_{which_epoch}.pth")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="explicit checkpoint path (.pth or .pkl); overrides "
                        "checkpoints_dir/which_epoch")
    p.add_argument("--results_dir", type=str, default="./results")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--init_random", action="store_true",
                   help="skip checkpoint loading (smoke runs)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights with --init_random")
    p.add_argument("--fast_inference", action="store_true",
                   help="constant-state-map modulation shortcut "
                        "(gan/fast_inference.py): same weights, pixels equal "
                        "up to float re-association")
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for parity with the JAX CLI: on CUDA the "
                        "fused MAT-norm kernel always runs")
    p.add_argument("--gb_int8", action="store_true",
                   help="with --fast_inference: int8 γ/β modulation convs (per-channel int8 "
                        "weights, per-sample activation scale, int32 accumulation); frames "
                        "differ from the float path by quantization noise")
    return p


def resolve_dataroot(dataroot: str, env_type: str) -> str:
    if osp.isdir(dataroot):
        return osp.join(dataroot, f"{env_type}.hdf5")
    return dataroot


def resolve_device(gpu_ids: str) -> torch.device:
    """``-1`` → CPU; otherwise the first listed CUDA index, which must exist."""
    first = int(gpu_ids.split(",")[0])
    if first < 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--gpu_ids={gpu_ids} asks for CUDA, which is not available; "
                           "pass --gpu_ids=-1 to run on the CPU")
    if first >= torch.cuda.device_count():
        raise RuntimeError(f"--gpu_ids={gpu_ids}: only {torch.cuda.device_count()} "
                           "CUDA device(s)")
    return torch.device("cuda", first)


def _mat_mode(netG: str) -> str:
    return "mat" if netG == "s2p" else netG


def main(argv: Optional[list] = None) -> str:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.gpu_ids)

    from s2p_tpu_torch.data.hdf5 import load_rl_dataset
    from s2p_tpu_torch.gan import S2PGenerator, generate_rollout, generate_rollout_fast
    from s2p_tpu_torch.gan.convert import load_generator_checkpoint

    _, default_len = ENV_DEFAULTS[args.env_type]
    L = args.seq_len if args.seq_len is not None else default_len
    t0 = args.start_idx

    ds = load_rl_dataset(resolve_dataroot(args.dataroot, args.env_type))
    imgs = ds["image_observations"]
    states = ds["next_observations"]
    if t0 + L > len(states):
        raise ValueError(f"start_idx={t0} + seq_len={L} exceeds dataset length {len(states)}")

    gen = S2PGenerator(states.shape[-1], image_size=imgs.shape[1], ngf=args.ngf,
                       mat_mode=_mat_mode(args.netG), seed=args.seed, device=device)
    if not args.init_random:
        ckpt = args.checkpoint or osp.join(
            args.checkpoints_dir, f"{args.env_type}_{args.which_epoch}.pth")
        load_generator_checkpoint(ckpt, gen)

    init_img = torch.from_numpy(imgs[t0].astype(np.float32) / 127.5 - 1.0)[None].to(device)
    roll_states = torch.from_numpy(states[t0:t0 + L].astype(np.float32))[:, None].to(device)
    if args.fast_inference:
        frames = generate_rollout_fast(gen, init_img, roll_states, gb_int8=args.gb_int8)
    else:
        frames = generate_rollout(gen, init_img, roll_states)
    frames = frames[:, 0].float().cpu().numpy()  # [L, H, W, C]
    frames_u8 = ((frames + 1.0) * 127.5).clip(0, 255).astype(np.uint8)

    out_dir = osp.join(args.results_dir, f"{args.env_type}_{args.netG}")
    os.makedirs(out_dir, exist_ok=True)
    import imageio.v2 as imageio

    imageio.imwrite(osp.join(out_dir, f"real_{t0:05d}.png"), imgs[t0])
    for i, fr in enumerate(frames_u8):
        imageio.imwrite(osp.join(out_dir, f"gen_{t0 + 1 + i:05d}.png"), fr)
    # side-by-side strip: generated row over ground-truth row when available
    gt = imgs[t0 + 1:t0 + 1 + L]
    strip = np.concatenate(list(frames_u8), axis=1)
    if len(gt) == L:
        strip = np.concatenate([strip, np.concatenate(list(gt), axis=1)], axis=0)
    imageio.imwrite(osp.join(out_dir, f"rollout_{t0:05d}.png"), strip)
    print(f"wrote {L} generated frames to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
