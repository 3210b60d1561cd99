"""Trainer and loss protocols, and the Serializable mixin.

The port of ``s2p_tpu/core/trainer.py``:

- ``Trainer``: ``train(data)``, ``end_epoch``, ``get_snapshot``,
  ``get_diagnostics``, the protocol the RL loops call;
- ``LossFunction``: ``compute_loss(batch, skip_statistics)``;
- ``Serializable``: captures constructor arguments
  (``quick_init(self, locals())``) so an object can be rebuilt from them,
  on unpickling or by ``clone``.
"""

from __future__ import annotations

import abc
import copy
from typing import Any, Dict


class Trainer(metaclass=abc.ABCMeta):
    @abc.abstractmethod
    def train(self, data) -> Any:
        ...

    def end_epoch(self, epoch: int) -> None:
        pass

    def get_snapshot(self) -> Dict[str, Any]:
        return {}

    def get_diagnostics(self) -> Dict[str, Any]:
        return {}


class LossFunction(metaclass=abc.ABCMeta):
    @abc.abstractmethod
    def compute_loss(self, batch, skip_statistics: bool = False):
        ...


class Serializable:
    """Keeps the constructor's arguments so the object can be rebuilt."""

    def quick_init(self, locals_: Dict[str, Any]) -> None:
        if getattr(self, "_serializable_initialized", False):
            return
        self.__args = {k: v for k, v in locals_.items() if k not in ("self", "__class__")}
        self._serializable_initialized = True

    def __getstate__(self) -> Dict[str, Any]:
        return {"__args": self.__args}

    def __setstate__(self, d: Dict[str, Any]) -> None:
        obj = type(self)(**d["__args"])
        self.__dict__.update(obj.__dict__)

    @classmethod
    def clone(cls, obj: "Serializable", **kwargs) -> "Serializable":
        args = copy.copy(obj._Serializable__args)
        args.update(kwargs)
        return cls(**args)
