"""On-device batch sampling for the trainers' multi-step loops.

The port of ``s2p_tpu/rl/scan_utils.py``. The reference's dual-buffer
configuration samples batch/2 real and batch/2 generated windows per
gradient step; here the indices come from a ``torch.Generator`` on the
buffers' device and the gather runs there.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from s2p_tpu_torch.data.replay import Batch, draw_indices, gather_windows, window_batch


def _sample_from(state: Dict, n: int, generator: torch.Generator):
    idx = draw_indices(0, state["n"], n, generator, state["windows"].device)
    return gather_windows(state, idx)


def make_window_sampler(buf_state: Dict, batch_size: int, generator: torch.Generator,
                        buf_gen_state: Optional[Dict] = None) -> Callable[[], Batch]:
    """``sample()`` → a SLAC window batch; with a generated-data buffer,
    the first half from ``buf_state`` and the rest from ``buf_gen_state``."""

    def sample() -> Batch:
        if buf_gen_state is None:
            return window_batch(*_sample_from(buf_state, batch_size, generator))
        half = batch_size // 2
        real = _sample_from(buf_state, half, generator)
        gen = _sample_from(buf_gen_state, batch_size - half, generator)
        return window_batch(*(torch.cat([r, g]) for r, g in zip(real, gen)))

    return sample


def make_flat_sampler(buf_state: Dict, batch_size: int, generator: torch.Generator
                      ) -> Callable[[], Batch]:
    """``sample()`` → a flat transition batch from a ``SimpleReplayBuffer``
    ``device_state()`` (the state-RL path)."""
    keys = ("observations", "actions", "rewards", "terminals", "next_observations")

    def sample() -> Batch:
        idx = draw_indices(0, buf_state["n"], batch_size, generator,
                           buf_state["actions"].device)
        return {k: buf_state[k][idx] for k in keys}

    return sample
