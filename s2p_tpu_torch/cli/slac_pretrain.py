"""``slac_pretrain`` — pretrain the SLAC latent model on an image dataset.

The port of the root ``slac_pretrain.py``, with the same flags and
``--gpu_ids``:

    python -m s2p_tpu_torch.cli.slac_pretrain --dataset real-rl.hdf5 \
        --save_dir ./slac_logs/model --gpu_ids=0

Fills the sequence buffer from the image-RL HDF5, runs ``--num_steps``
ELBO steps at ``--batch_size`` windows and writes ``latent.pkl`` and
``encoder.pkl`` (numpy trees under flax names, which the JAX package's
``SlacAlgorithm.load_latent`` reads) to ``--save_dir`` every
``--save_every`` steps and at the end.

``--gpu_ids``: ``0`` (the default) runs on ``cuda:0``, ``-1`` on the CPU.
Without CUDA any id other than -1 is an error.
"""

from __future__ import annotations

import argparse
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True, help="image RL HDF5 (image_render.py output)")
    p.add_argument("--action_dim", type=int, default=None,
                   help="default: inferred from the dataset")
    p.add_argument("--num_steps", type=int, default=300_000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--save_every", type=int, default=5_000)
    p.add_argument("--save_dir", default="./slac_logs/model")
    p.add_argument("--num_sequences", type=int, default=8)
    p.add_argument("--image_size", type=int, default=None,
                   help="default: inferred from the dataset (64 or 100)")
    p.add_argument("--feature_dim", type=int, default=256)
    p.add_argument("--z1_dim", type=int, default=32)
    p.add_argument("--z2_dim", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_num", type=int, default=None)
    p.add_argument("--log_every", type=int, default=1_000)
    p.add_argument("--scan_chunk", type=int, default=1_000,
                   help="ELBO steps per host round (logs and checkpoints fall on its "
                        "boundaries)")
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="CUDA device index (first of a comma list); -1 runs on the CPU")
    return p


def main(argv: Optional[list] = None) -> str:
    args = build_parser().parse_args(argv)
    from s2p_tpu_torch.cli.simple_test import resolve_device

    device = resolve_device(args.gpu_ids)

    from s2p_tpu_torch.data.hdf5 import load_rl_dataset
    from s2p_tpu_torch.slac import SlacAlgorithm, pretrain_latent
    from s2p_tpu_torch.utils.seeding import set_seed

    set_seed(args.seed)
    ds = load_rl_dataset(args.dataset, args.data_num)
    algo = SlacAlgorithm(
        action_dim=args.action_dim or ds["actions"].shape[1],
        num_sequences=args.num_sequences,
        buffer_size=max(len(ds["actions"]) + 10, 1000),
        batch_size_latent=args.batch_size, lr_latent=args.lr, feature_dim=args.feature_dim,
        z1_dim=args.z1_dim, z2_dim=args.z2_dim,
        image_size=args.image_size or ds["image_observations"].shape[1], seed=args.seed,
        device=device)
    added = algo.buffer.ingest_real(ds)
    print(f"buffer: {added} sequence windows from {args.dataset}")
    pretrain_latent(algo, num_steps=args.num_steps, save_every=args.save_every,
                    save_dir=args.save_dir, log_every=args.log_every,
                    scan_chunk=args.scan_chunk)
    print(f"saved latent checkpoint to {args.save_dir}/latent.pkl")
    return args.save_dir


if __name__ == "__main__":
    main()
