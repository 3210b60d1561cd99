"""Phase timers.

The port of ``s2p_tpu/utils/timer.py``: ``PhaseTimer`` charges the wall time
between stamps to named loop phases and gives the ``time/<phase> (s)``
epoch columns; ``Timer`` is a start/stop timer. ``sync=`` waits for the
device work behind a tensor (or a dict, list or tuple of them) before the
clock is read, so that device work is charged to the phase that launched
it (the JAX package blocks until its arrays are ready).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Dict, Iterator

import torch


def block_until_ready(tree: Any) -> None:
    """Wait for the card to finish the work behind every CUDA tensor in
    ``tree``; CPU tensors are ready when they exist."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            block_until_ready(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            block_until_ready(v)


class PhaseTimer:
    """Accumulates wall time per named phase within an epoch."""

    def __init__(self) -> None:
        self._epoch_times: "OrderedDict[str, float]" = OrderedDict()
        self._total_times: "OrderedDict[str, float]" = OrderedDict()
        self._last_stamp = time.monotonic()
        self._epoch_start = self._last_stamp
        self._run_start = self._last_stamp

    def stamp(self, phase: str, sync: Any = None) -> float:
        """Charge the time since the previous stamp to ``phase``, after the
        device work behind ``sync`` (tensors) has finished."""
        if sync is not None:
            block_until_ready(sync)
        now = time.monotonic()
        dt = now - self._last_stamp
        self._last_stamp = now
        self._epoch_times[phase] = self._epoch_times.get(phase, 0.0) + dt
        self._total_times[phase] = self._total_times.get(phase, 0.0) + dt
        return dt

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        self._last_stamp = time.monotonic()
        try:
            yield
        finally:
            self.stamp(name)

    def end_epoch(self) -> Dict[str, float]:
        """The ``time/`` columns of this epoch; the epoch counters restart."""
        now = time.monotonic()
        out: "OrderedDict[str, float]" = OrderedDict()
        for phase, t in self._epoch_times.items():
            out[f"time/{phase} (s)"] = t
        out["time/epoch (s)"] = now - self._epoch_start
        out["time/total (s)"] = now - self._run_start
        self._epoch_times.clear()
        self._epoch_start = now
        self._last_stamp = now
        return out

    def totals(self) -> Dict[str, float]:
        return dict(self._total_times)


class Timer:
    """A start/stop timer with per-epoch and global sums."""

    def __init__(self, return_global_times: bool = False) -> None:
        self.return_global_times = return_global_times
        self.reset()

    def reset(self) -> None:
        self.stamps: "OrderedDict[str, float]" = OrderedDict()
        self.global_stamps: "OrderedDict[str, float]" = OrderedDict()
        self._start: Dict[str, float] = {}
        self.epoch_start = time.monotonic()
        self.global_start = self.epoch_start

    def start_timer(self, name: str, unique: bool = True) -> None:
        if unique and name in self._start:
            raise RuntimeError(f"timer {name!r} already running")
        self._start[name] = time.monotonic()

    def stop_timer(self, name: str) -> float:
        dt = time.monotonic() - self._start.pop(name)
        self.stamps[name] = self.stamps.get(name, 0.0) + dt
        self.global_stamps[name] = self.global_stamps.get(name, 0.0) + dt
        return dt

    def get_times(self) -> Dict[str, float]:
        times = dict(self.stamps)
        times["epoch_time"] = time.monotonic() - self.epoch_start
        if self.return_global_times:
            times.update({f"global/{k}": v for k, v in self.global_stamps.items()})
            times["global/total_time"] = time.monotonic() - self.global_start
        return times

    def start_epoch(self) -> None:
        self.stamps.clear()
        self.epoch_start = time.monotonic()
