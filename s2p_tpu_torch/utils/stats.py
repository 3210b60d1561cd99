"""Diagnostic statistics: the port of ``s2p_tpu/utils/stats.py`` (plain numpy).

``create_stats_ordered_dict`` and ``get_generic_path_information`` name the
progress.csv columns of the trainers and collectors (rlkit's
``core/eval_util.py``), so the frozen-key contract carries over.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Mapping, Sequence

import numpy as np


def create_stats_ordered_dict(
    name: str,
    data: Any,
    stat_prefix: str = "",
    always_show_all_stats: bool = True,
    exclude_max_min: bool = False,
) -> "OrderedDict[str, float]":
    name = stat_prefix + name
    stats: "OrderedDict[str, float]" = OrderedDict()
    arr = np.asarray(data, dtype=np.float64).ravel()
    if arr.size == 0:
        return stats
    if arr.size == 1 and not always_show_all_stats:
        stats[name] = float(arr[0])
        return stats
    stats[f"{name} Mean"] = float(np.mean(arr))
    stats[f"{name} Std"] = float(np.std(arr))
    if not exclude_max_min:
        stats[f"{name} Max"] = float(np.max(arr))
        stats[f"{name} Min"] = float(np.min(arr))
    return stats


def get_generic_path_information(
    paths: Sequence[Mapping[str, Any]], stat_prefix: str = ""
) -> "OrderedDict[str, float]":
    """Per-path return/reward/length stats (rlkit/core/eval_util.py:13-63)."""
    stats: "OrderedDict[str, float]" = OrderedDict()
    if not paths:
        return stats
    returns = [float(np.sum(p["rewards"])) for p in paths]
    rewards = np.concatenate([np.asarray(p["rewards"]).ravel() for p in paths])
    lengths = [len(np.asarray(p["rewards"]).ravel()) for p in paths]
    stats.update(create_stats_ordered_dict("Rewards", rewards, stat_prefix))
    stats.update(create_stats_ordered_dict("Returns", returns, stat_prefix))
    stats.update(create_stats_ordered_dict("Path Lengths", lengths, stat_prefix))
    if "actions" in paths[0]:
        actions = np.vstack([np.asarray(p["actions"]).reshape(len(p["actions"]), -1) for p in paths])
        stats.update(create_stats_ordered_dict("Actions", actions, stat_prefix))
    stats[f"{stat_prefix}Num Paths"] = float(len(paths))
    stats[f"{stat_prefix}Average Returns"] = float(np.mean(returns))
    return stats


def list_of_dicts_to_dict_of_lists(
    dicts: Iterable[Mapping[str, Any]]
) -> Dict[str, List[Any]]:
    """rlkit/pythonplusplus.py utility used throughout the loop."""
    out: Dict[str, List[Any]] = {}
    for d in dicts:
        for k, v in d.items():
            out.setdefault(k, []).append(v)
    return out
