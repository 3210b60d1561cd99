"""On-device batch sampling for the trainers' multi-step loops.

The port of ``s2p_tpu/rl/scan_utils.py``. The reference's dual-buffer
configuration samples batch/2 real and batch/2 generated windows per
gradient step; here the indices come from a ``torch.Generator`` on the
buffers' device and the gather runs there. ``train_many`` is the loop the
IQL and CQL trainers share (the JAX package scans it); ``train_many_dp``
runs it data-parallel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from s2p_tpu_torch.data.replay import Batch, draw_indices, gather_windows, window_batch
from s2p_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


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


def make_flat_sampler(buf_state: Dict, batch_size: int, generator: torch.Generator,
                      indices: Optional[Any] = None) -> Callable[[], Batch]:
    """``sample()`` → a flat transition batch from a ``SimpleReplayBuffer``
    ``device_state()`` (the state-RL path); with ``indices`` ([steps,
    batch_size] rows), the rows of the next step."""
    keys = ("observations", "actions", "rewards", "terminals", "next_observations")
    device = buf_state["actions"].device
    steps = iter(indices) if indices is not None else None

    def sample() -> Batch:
        idx = (draw_indices(0, buf_state["n"], batch_size, generator, device)
               if steps is None else torch.as_tensor(next(steps), device=device))
        return {k: buf_state[k][idx] for k in keys}

    return sample


def train_many(trainer, num_steps: int, batch_size: int, buffer=None, buffer_gen=None,
               indices: Optional[Any] = None,
               draws: Optional[Sequence[Any]] = None) -> Dict[str, torch.Tensor]:
    """``num_steps`` of ``trainer._step`` with batches drawn on the device
    from ``trainer.generator``. SLAC path: windows of ``buffer`` (the SLAC
    main buffer by default), half of each batch from ``buffer_gen`` when
    given, and the joint latent step on ``buffer`` after each RL step when
    the latent is unfrozen with period 1. State path: flat batches of a
    ``SimpleReplayBuffer``, at the rows ``indices`` ([num_steps,
    batch_size]) when given. ``draws`` (one per step: the second argument
    of ``trainer._step``) replace the generator's draws of a step, for
    comparisons. Returns the last step's metrics; the host waits for none
    of them."""
    slac = trainer.slac_algo
    if slac is None:
        if buffer is None or buffer_gen is not None:
            raise ValueError("the state path takes one SimpleReplayBuffer")
        sample = make_flat_sampler(buffer.device_state(), batch_size, trainer.generator,
                                   indices)
        joint = False
    else:
        if indices is not None:
            raise ValueError("given indices are rows of the state path's buffer")
        buffer = slac.buffer if buffer is None else buffer
        sample = make_window_sampler(
            buffer.device_state(), batch_size, trainer.generator,
            buffer_gen.device_state() if buffer_gen is not None else None)
        joint = not trainer.freeze_slac and trainer.slac_update_period == 1
    metrics: Dict[str, torch.Tensor] = {}
    for step in range(num_steps):
        metrics = trainer._step(sample(), None if draws is None else draws[step])
        if joint:
            metrics.update(slac.update_latent(buffer))
        trainer._n_train_steps_total += 1
    trainer._record(metrics)
    return metrics


def train_many_dp(trainer, mesh: Mesh, num_steps: int, batch_size: int, buffer=None,
                  buffer_gen=None, indices: Optional[Any] = None,
                  draws: Optional[Sequence[Any]] = None) -> Dict[str, torch.Tensor]:
    """``train_many`` data-parallel over ``mesh``'s data axis, the port of
    the JAX package's trainers scanned with their batch (or the buffer's
    rows) sharded over 'data'.

    ``batch_size`` is the global batch: each of the d data ranks draws
    ``batch_size``/d rows per step (half of them from ``buffer_gen`` when
    it is given) from the trainer's generator, which the trainer seeds per
    rank, and the joint latent step draws ``batch_size_latent``/d windows
    a rank. The trainer (and its SLAC algorithm) must have been built with
    the mesh's data group, so every gradient and metric is averaged over
    the ranks. ``indices`` ([num_steps, batch_size/d], the state path) and
    ``draws`` are this rank's, as ``train_many`` takes them.

    Every rank holds the whole buffer or frame pool. JAX shards the pool's
    rows but samples over all of them, so its sharding is a storage layout
    only; a pool cut into per-rank shards would cut SLAC windows at the
    shard boundaries. Returns the last step's metrics, averaged over the
    ranks.
    """
    d, group = mesh.shape[DATA_AXIS], mesh.groups[DATA_AXIS]
    if batch_size % d or (buffer_gen is not None and (batch_size // d) % 2):
        raise ValueError(f"global batch {batch_size} does not divide over {d} data ranks"
                         + (" in two halves" if buffer_gen is not None else ""))
    slac = trainer.slac_algo
    if trainer.dp_group is not group or (slac is not None and slac.dp_group is not group):
        raise ValueError("the trainer's dp_group is not the mesh's data group")
    return train_many(trainer, num_steps, batch_size // d, buffer, buffer_gen, indices, draws)
