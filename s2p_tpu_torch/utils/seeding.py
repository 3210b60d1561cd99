"""Seed discipline: the port of ``s2p_tpu/utils/seeding.py``.

- ``set_seed`` seeds python, numpy and torch globally (host-side shuffling,
  env seeding) and returns a seeded CPU ``torch.Generator``;
- ``RngStream`` hands out named, independent streams, so every consumer
  (initialisation, sampling, buffer draws) gets its own reproducible
  generator and one root seed reproduces the run. JAX folds the name's
  hash and a counter into its root key; the port derives a generator's
  seed from the same three numbers. The streams are reproducible, not
  equal to JAX's threefry draws.
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed python, numpy and torch (every device) globally, for host-side
    shuffling; returns a CPU ``torch.Generator`` seeded the same, for code
    that takes its randomness explicitly."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


class RngStream:
    """Named generator dispenser: ``next("name")`` returns a fresh
    ``torch.Generator`` seeded from (root seed, the name's stable hash, the
    name's counter), so streams of different names are independent and a
    run with the same root seed draws the same numbers."""

    def __init__(self, seed: int) -> None:
        self._seed = seed
        self._counters: Dict[str, int] = {}

    def _seeds(self, name: str, n: int) -> np.ndarray:
        i = self._counters.get(name, 0)
        self._counters[name] = i + 1
        entropy = [self._seed % 2**64, _stable_hash(name), i]
        return np.random.SeedSequence(entropy).generate_state(n, np.uint64) >> np.uint64(1)

    def next(self, name: str = "default") -> torch.Generator:
        return torch.Generator().manual_seed(int(self._seeds(name, 1)[0]))

    def next_n(self, n: int, name: str = "default") -> List[torch.Generator]:
        """``n`` independent generators from one step of the stream (JAX
        splits one key ``n`` ways)."""
        return [torch.Generator().manual_seed(int(s)) for s in self._seeds(name, n)]

    def state(self) -> Dict[str, int]:
        """Counters for checkpoint/resume."""
        return dict(self._counters)

    def restore(self, counters: Dict[str, int]) -> None:
        self._counters = dict(counters)


def _stable_hash(s: str) -> int:
    # Python's hash() is salted per process: FNV-1a is the same everywhere
    h = 2166136261
    for b in s.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h
