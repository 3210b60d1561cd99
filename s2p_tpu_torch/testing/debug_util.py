"""Golden-tensor trace debugging: the port of ``s2p_tpu/testing/debug_util.py``.

Capability contract (reference: rlkit/testing/debug_util.py — ``save/load/
savei/loadi`` dump intermediate tensors to disk so two implementations can
be diffed step-by-step). This is the tool the torch↔JAX parity work uses
(SURVEY §4): dump activations from one implementation, replay them against
the other."""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Any

import numpy as np


def _to_host(x: Any) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_tensor(x: Any, path: str) -> str:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_host(x), f)
    return path


def load_tensor(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return pickle.load(f)


class TensorTrace:
    """Indexed trace: ``trace.save(x)`` appends; ``trace.load(i)`` reads —
    the reference's savei/loadi counter pattern."""

    def __init__(self, directory: str, name: str = "trace"):
        self.directory = directory
        self.name = name
        self._i = 0
        os.makedirs(directory, exist_ok=True)

    def save(self, x: Any) -> str:
        path = osp.join(self.directory, f"{self.name}_{self._i}.pkl")
        self._i += 1
        return save_tensor(x, path)

    def load(self, i: int) -> np.ndarray:
        return load_tensor(osp.join(self.directory, f"{self.name}_{i}.pkl"))

    def compare(self, other: "TensorTrace", atol: float = 1e-5) -> None:
        for i in range(self._i):
            a, b = self.load(i), other.load(i)
            np.testing.assert_allclose(a, b, atol=atol, err_msg=f"trace idx {i}")
