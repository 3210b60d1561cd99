"""Seed discipline: the port of ``s2p_tpu/utils/seeding.py::set_seed``."""

from __future__ import annotations

import random

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
