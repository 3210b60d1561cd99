"""Standalone SLAC latent-model pretraining (the producer of latent.pkl).

The port of ``s2p_tpu/slac/pretrain.py``: fill the sequence buffer from the
real HDF5 (or use what it holds), run ``num_steps`` ELBO updates (the
reference's default 300k at batch 32) and checkpoint every ``save_every``
steps to ``save_dir``. Steps run in chunks of ``scan_chunk`` (the JAX
package folds a chunk into one compiled scan; here a chunk is a loop of
eager steps): the host reads the losses, logs and checkpoints only at
chunk boundaries, so the card is not waited for between them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from s2p_tpu_torch.slac.algo import SlacAlgorithm


def pretrain_latent(algo: SlacAlgorithm, dataset_path: Optional[str] = None,
                    num_steps: int = 300_000, save_every: int = 5_000,
                    save_dir: Optional[str] = None, log_every: int = 1_000,
                    log_fn: Callable[[str], None] = print,
                    scan_chunk: int = 1_000) -> Dict[str, float]:
    """Returns the last step's losses as floats."""
    if dataset_path is not None:
        added = algo.load_data_in_buffer(dataset_path)
        log_fn(f"buffer filled with {added} sequence slots from {dataset_path}")
    if len(algo.buffer) == 0:
        raise ValueError("the buffer is empty")
    t0 = time.time()
    losses: Dict = {}
    chunk = max(1, min(scan_chunk, save_every if save_dir else scan_chunk,
                       log_every or scan_chunk))
    i = 0
    while i < num_steps:
        n = min(chunk, num_steps - i)
        losses = algo.update_latent_many(n)
        i += n
        if log_every and i % log_every == 0:
            rate = i / (time.time() - t0)
            log_fn(f"latent step {i}/{num_steps} ({rate:.1f} it/s): "
                   + " ".join(f"{k}={float(v):.3f}" for k, v in losses.items()))
        if save_dir is not None and i % save_every == 0:
            algo.save_model(save_dir)
    if save_dir is not None:
        algo.save_model(save_dir)
    return {k: float(v) for k, v in losses.items()}
