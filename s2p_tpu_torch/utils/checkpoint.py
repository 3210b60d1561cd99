"""Resumable training checkpoints.

The port of ``s2p_tpu/utils/checkpoint.py``, with ``torch.save`` in place of
orbax: one ``step_{N}.pt`` per saved step in ``directory``, written to a
temporary file and renamed, the newest ``max_to_keep`` kept. Also the
reader of the JAX package's pickled parameter trees (``load_numpy_pickle``).
"""

from __future__ import annotations

import os
import pickle
import re
import tempfile
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: Any) -> None:
        """Save ``state`` (nested dicts and lists of tensors and numbers, as
        module and optimizer state dicts are) as step ``step``."""
        fd, tmp = tempfile.mkstemp(suffix=".pt.tmp", dir=self.directory)
        os.close(fd)
        try:
            torch.save(state, tmp)
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (the latest when None), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Refuses JAX and flax objects, whose unpickling would import JAX."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ValueError(f"the pickle holds {module}.{name}: write the parameters with "
                             "numpy leaves, pickle.dump(jax.device_get(params), f)")
        return super().find_class(module, name)


def load_numpy_pickle(path: str) -> Any:
    """A pickled parameter tree with numpy leaves (what the JAX package
    writes after ``jax.device_get``); a pickle of ``jax.Array``s is refused
    without importing JAX."""
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()
