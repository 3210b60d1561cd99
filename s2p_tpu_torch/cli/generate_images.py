"""``generate_images`` — S2P frames for an augmented dataset (the GAN→RL
bridge).

The port of ``s2p_tpu/cli/generate_images.py``, with the same flags:

    python -m s2p_tpu_torch.cli.generate_images --dataset augment.hdf5 \
        --checkpoint cheetah_30.pth --output augment-rl.hdf5 --bf16 --gpu_ids=0

The world-model rollout (``cli/state_transition_rollout.py``) writes
synthetic transitions without next images. For each row i this renders
``image_observations_tp1[i] = G(next_observations[i],
image_observations[i])``, batch by batch, and writes the ``-rl.hdf5`` that
offline RL reads. A ``netG=s2p`` generator (``mat_mode`` 'mat') renders on
the fast path (``gan/fast_inference.py``: the state half of every MAT
condition by the constant-map shortcut, its operands fused once a call);
the ``sat_*`` generators, which the fast path does not specialise, on the
module path.

``--gpu_ids``: ``0`` (the default) runs on ``cuda:0``, ``-1`` on the CPU.
Without CUDA any id other than -1 is an error.
"""

from __future__ import annotations

import argparse
import copy
from typing import Optional

import numpy as np
import torch

from s2p_tpu_torch.gan.fast_inference import fast_apply, fuse_fast_params
from s2p_tpu_torch.utils.profiling import annotate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True, help="augment HDF5 (no next images yet)")
    p.add_argument("--checkpoint", required=True,
                   help="S2P generator checkpoint (.pth or .pkl)")
    p.add_argument("--output", required=True, help="output -rl.hdf5 path")
    p.add_argument("--netG", type=str, default="s2p",
                   choices=["s2p", "sat_state", "sat_image"])
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--bf16", action="store_true", help="run the generator in bfloat16")
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="CUDA device index (first of a comma list); -1 runs on the CPU")
    return p


@torch.no_grad()
def generate_images_for_dataset(dataset: dict, gen: torch.nn.Module, batch_size: int = 256,
                                bf16: bool = False) -> np.ndarray:
    """Generated uint8 frames ``[N, H, W, C]``: ``gen(next_observations,
    image_observations / 127.5 − 1)`` in ``batch_size`` rows at a time (the
    tail padded to one batch shape), on ``gen``'s device; with ``bf16`` a
    bfloat16 copy of ``gen`` runs. A 'mat' generator runs ``fast_apply``
    on operands fused once, after the copy; the others run ``gen`` itself.
    Batches are dispatched without waiting for the card; each result is
    copied without blocking into one pinned host buffer, which is read
    after a single synchronisation. Spans:
    ``s2p.bridge.stage`` (host rows to device inputs), ``s2p.bridge.d2h``
    (uint8 frames into the pinned buffer), ``s2p.bridge.sync``."""
    imgs = np.asarray(dataset["image_observations"])
    states = np.asarray(dataset["next_observations"], np.float32)
    n = len(states)
    device = next(gen.parameters()).device
    dtype = torch.bfloat16 if bf16 else torch.float32
    if next(gen.parameters()).dtype != dtype:
        gen = copy.deepcopy(gen).to(dtype)
    if gen.mat_mode == "mat":
        params = fuse_fast_params(gen)
        render = lambda state, prev: fast_apply(gen, params, state, prev)
    else:
        render = gen

    n_batches = -(-n // batch_size)
    out = torch.empty((n_batches * batch_size,) + imgs.shape[1:], dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    for i in range(n_batches):
        lo = i * batch_size
        with annotate("s2p.bridge.stage"):
            s, p = states[lo:lo + batch_size], imgs[lo:lo + batch_size]
            pad = batch_size - len(s)
            if pad:
                s = np.concatenate([s, np.zeros((pad,) + s.shape[1:], s.dtype)])
                p = np.concatenate([p, np.zeros((pad,) + p.shape[1:], p.dtype)])
            state = torch.from_numpy(s).to(device, non_blocking=True).to(dtype)
            prev = torch.from_numpy(p).to(device, non_blocking=True).to(dtype) / 127.5 - 1.0
        frames = render(state, prev)
        with annotate("s2p.bridge.d2h"):
            frames = ((frames.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
            out[lo:lo + batch_size].copy_(frames, non_blocking=True)
    if device.type == "cuda":
        with annotate("s2p.bridge.sync"):
            torch.cuda.synchronize(device)
    return out[:n].numpy()


def main(argv: Optional[list] = None) -> str:
    args = build_parser().parse_args(argv)
    from s2p_tpu_torch.cli.simple_test import resolve_device

    device = resolve_device(args.gpu_ids)

    from s2p_tpu_torch.data.hdf5 import load_augment_dataset, save_dataset
    from s2p_tpu_torch.gan import S2PGenerator
    from s2p_tpu_torch.gan.convert import load_generator_checkpoint

    ds = load_augment_dataset(args.dataset)
    if "image_observations" not in ds:
        raise KeyError(f"{args.dataset} has no image_observations: the bridge needs the i_t frames")
    H = ds["image_observations"].shape[1]
    mat_mode = "mat" if args.netG == "s2p" else args.netG
    gen = S2PGenerator(ds["next_observations"].shape[1], image_size=H, ngf=args.ngf,
                       mat_mode=mat_mode, device=device)
    load_generator_checkpoint(args.checkpoint, gen)
    frames = generate_images_for_dataset(ds, gen, batch_size=args.batch_size, bf16=args.bf16)
    out = dict(ds)
    out["image_observations_tp1"] = frames
    save_dataset(args.output, out)
    print(f"wrote {len(frames)} generated frames to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
