"""Nested experiment config: the port of ``s2p_tpu/utils/config.py`` (plain
Python).

A dict of the entry scripts' "variant" shape (``algo_kwargs``,
``trainer_kwargs``, ...) with attribute access, deep updates, flattening
and JSON round-tripping (``variant.json``).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Mapping

from s2p_tpu_torch.utils.logging import _json_default


class Config(dict):
    """A dict with attribute access that recursively wraps nested mappings.

    >>> c = Config(trainer_kwargs=dict(discount=0.99))
    >>> c.trainer_kwargs.discount
    0.99
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        data: dict = dict(*args, **kwargs)
        for k, v in data.items():
            self[k] = v

    # -- item/attr protocol ------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]

    # -- functional helpers ------------------------------------------------
    def deep_update(self, other: Mapping[str, Any]) -> "Config":
        """Recursively merge ``other`` into a copy of self and return it."""
        out = copy.deepcopy(self)
        _deep_update_inplace(out, other)
        return out

    def flatten(self, sep: str = ".") -> dict:
        """Flatten into {"a.b.c": leaf} — handy for sweepers and logging."""
        flat: dict = {}

        def rec(prefix: str, node: Any) -> None:
            if isinstance(node, Mapping):
                for k, v in node.items():
                    rec(f"{prefix}{sep}{k}" if prefix else str(k), v)
            else:
                flat[prefix] = node

        rec("", self)
        return flat

    def to_dict(self) -> dict:
        return json.loads(self.to_json())

    def to_json(self, **kwargs: Any) -> str:
        kwargs.setdefault("indent", 2)
        kwargs.setdefault("sort_keys", True)
        kwargs.setdefault("default", _json_default)
        return json.dumps(self, **kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(json.loads(s))

    def set_path(self, dotted: str, value: Any) -> None:
        """Set a value by dotted path, creating intermediate Configs."""
        node = self
        *parents, leaf = dotted.split(".")
        for p in parents:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[leaf] = value

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted.split("."):
            if not isinstance(node, Mapping) or p not in node:
                return default
            node = node[p]
        return node


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def _deep_update_inplace(dst: Config, src: Mapping[str, Any]) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], Mapping) and isinstance(v, Mapping):
            _deep_update_inplace(dst[k], v)
        else:
            dst[k] = v
