"""``dryrun`` — the flagship forward step and the multi-rank dry run.

The port of the repo's ``__graft_entry__.py``:

- ``entry()`` → the S2P generator's forward (i_{t+1} = G(s_{t+1}, i_t)) at
  full width (64px, ngf 64) on a batch of 8, and its example arguments;
- ``dryrun_multichip(n)`` → ``n`` ranks on ``torch.distributed`` run every
  multi-device path of the port once, at the JAX dry run's tiny shapes: one
  data-parallel GAN step (G and D, hinge + FM + L1 + VGG), one IQL + SLAC
  step on a sharded batch, ``GANTrainer.train_many_dp``, the state and
  image IQL and CQL ``train_many_dp`` loops (joint latent step, real and
  generated pools), and, when ``n`` is even and ≥ 4, the tensor-parallel
  generator on an (n/2) × 2 data × model mesh, held to its unsharded
  forward within 1e-4 (``s2p_tpu_torch/testing/dryrun_worker.py``).

    python -m s2p_tpu_torch.cli.dryrun [N] [--device cpu]

Both run on the card unless the caller asks for the CPU, and raise without
CUDA otherwise. The ranks are spawned here (no ``torchrun``): rank r runs on
``cuda:(r mod device_count)``, over NCCL when every rank has a card of its
own and gloo when ranks share one; ``--device cpu`` runs every rank on the
CPU over gloo. N defaults to the number of cards, or 2 on the CPU. Rank 0
prints one line per leg with its wall seconds, the backend and the
devices. A failing or hung rank makes the call raise, and so do ranks
whose parameters differ after a leg that trains.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from s2p_tpu_torch.gan.generator import S2PGenerator
from s2p_tpu_torch.parallel.distributed import spawn_ranks
from s2p_tpu_torch.testing import dryrun_worker

STATE_DIM = dryrun_worker.STATE_DIM
ENTRY_BATCH, ENTRY_SIZE, ENTRY_NGF = 8, 64, 64
TIMEOUT_S = 300.0  # before the ranks are killed; a dry run takes under a minute


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``device`` as given; None → the card, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def entry(device: Optional[str | torch.device] = None,
          state_dict: Optional[Mapping[str, torch.Tensor]] = None
          ) -> Tuple[Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]:
    """``(fn, (state, prev_image))``: ``fn`` the generator's f32 forward
    (``S2PGenerator(image_size=64, ngf=64)``, weights from seed 0 or
    ``state_dict``), the arguments zeros of [8, 17] and [8, 64, 64, 3] on
    the device. On the card each call launches the MAT-norm kernel once per
    norm (13)."""
    dev = resolve_device(device)
    gen = S2PGenerator(STATE_DIM, image_size=ENTRY_SIZE, ngf=ENTRY_NGF, device=dev)
    if state_dict is not None:
        gen.load_state_dict(state_dict, strict=True)
    state = torch.zeros(ENTRY_BATCH, STATE_DIM, device=dev)
    prev = torch.zeros(ENTRY_BATCH, ENTRY_SIZE, ENTRY_SIZE, 3, device=dev)

    @torch.no_grad()
    def fn(state: torch.Tensor, prev_image: torch.Tensor) -> torch.Tensor:
        return gen(state, prev_image)

    return fn, (state, prev)


def dryrun_multichip(n_devices: int, device: Optional[str | torch.device] = None
                     ) -> Dict[str, Any]:
    """Run the dry run's legs on ``n_devices`` ranks (on the cards, or on the
    CPU with ``device="cpu"``); raises if a rank fails or outlives
    ``TIMEOUT_S`` seconds, or if the ranks' trained parameters differ. Returns
    rank 0's printed ``lines`` and ``ranks``, each rank's record of its legs
    (name, seconds, metrics, MAT-norm launches forward and backward, the
    digest of the parameters it trained)."""
    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    sys.stdout.flush()  # the ranks print to the same stream, after what came before
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out_dir:
        spawn_ranks(dryrun_worker.run, n_devices, (dev.type, out_dir), timeout=TIMEOUT_S)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(n_devices)]
    for legs in zip(*(r["legs"] for r in ranks)):
        if len({leg["digest"] for leg in legs}) != 1:
            raise RuntimeError(f"dryrun_multichip({n_devices}) {legs[0]['name']}: the ranks' "
                               "parameters differ after the leg")
    return dict(lines=ranks[0]["lines"], ranks=ranks)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_devices", nargs="?", type=int, default=None,
                    help="ranks (default: the number of cards, or 2 with --device cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu runs every rank on the CPU over gloo (default: the cards)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n_devices
    if n is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 2
    dryrun_multichip(n, dev)


if __name__ == "__main__":
    main()
