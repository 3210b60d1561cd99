"""Functional dict/list utilities: the port of ``s2p_tpu/utils/pyutil.py``.

Capability contract (reference: rlkit/pythonplusplus.py, 458 LoC — the
subset the rlkit stack actually calls): dot-map ↔ nested dict conversion,
recursive merge, dict-of-lists ↔ list-of-dicts, safe JSON coercion,
identity, batch/treemap helpers."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence

from s2p_tpu_torch.utils.stats import list_of_dicts_to_dict_of_lists


def identity(x: Any) -> Any:
    return x


def dot_map_dict_to_nested_dict(dot_map: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a.b": 1} → {"a": {"b": 1}} (reference :38-77)."""
    out: Dict[str, Any] = {}
    for key, item in dot_map.items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"path conflict at {p!r}")
        node[leaf] = item
    return out


def nested_dict_to_dot_map_dict(d: Mapping[str, Any],
                                parent_key: str = "") -> Dict[str, Any]:
    """Inverse of dot_map_dict_to_nested_dict (reference :80-95)."""
    items: Dict[str, Any] = {}
    for k, v in d.items():
        new_key = f"{parent_key}.{k}" if parent_key else str(k)
        if isinstance(v, Mapping):
            items.update(nested_dict_to_dot_map_dict(v, new_key))
        else:
            items[new_key] = v
    return items


def merge_recursive_dicts(a: Dict, b: Mapping, path: List[str] = None,
                          ignore_duplicate_keys_in_second_dict: bool = False) -> Dict:
    """Merge b into a, recursing on shared dict values (reference :98-121)."""
    path = path or []
    for key in b:
        if key in a:
            if isinstance(a[key], dict) and isinstance(b[key], Mapping):
                merge_recursive_dicts(
                    a[key], b[key], path + [str(key)],
                    ignore_duplicate_keys_in_second_dict,
                )
            elif a[key] == b[key]:
                pass
            elif not ignore_duplicate_keys_in_second_dict:
                raise KeyError(
                    f"duplicate key at {'.'.join(path + [str(key)])}"
                )
        else:
            a[key] = b[key]
    return a


def dict_of_list__to__list_of_dicts(d: Mapping[str, Sequence],
                                    n_items: int) -> List[Dict]:
    """(reference :124-144)."""
    return [{k: d[k][i] for k in d} for i in range(n_items)]


def list_of_dicts__to__dict_of_lists(lst: Sequence[Mapping]) -> Dict[str, List]:
    """``utils.stats.list_of_dicts_to_dict_of_lists``, which the loop's stats
    path uses, after checking that every dict has the first one's keys
    (reference :147-165)."""
    keys = set(lst[0]) if lst else set()
    if any(set(d) != keys for d in lst):
        raise ValueError("inconsistent keys across dicts")
    return list_of_dicts_to_dict_of_lists(lst)


def safe_json(data: Any) -> bool:
    """Is ``data`` directly JSON-serializable (reference safe_json)?"""
    if data is None or isinstance(data, (bool, int, float, str)):
        return True
    if isinstance(data, (tuple, list)):
        return all(safe_json(x) for x in data)
    if isinstance(data, dict):
        return all(isinstance(k, str) and safe_json(v) for k, v in data.items())
    return False


def dict_to_safe_json(d: Mapping[str, Any]) -> Dict[str, Any]:
    """Coerce unserializable leaves to str (reference dict_to_safe_json)."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if safe_json(v):
            out[str(k)] = v
        elif isinstance(v, Mapping):
            out[str(k)] = dict_to_safe_json(v)
        else:
            out[str(k)] = str(v)
    return out


def treemap(f: Callable, *trees: Any, atomic_type=None) -> Any:
    """Map f over parallel nested dict/list structures (reference treemap)."""
    t0 = trees[0]
    if atomic_type is not None and isinstance(t0, atomic_type):
        return f(*trees)
    if isinstance(t0, dict):
        return {k: treemap(f, *(t[k] for t in trees), atomic_type=atomic_type)
                for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(
            treemap(f, *items, atomic_type=atomic_type) for items in zip(*trees)
        )
    return f(*trees)
