"""Post-hoc plotting over progress.csv runs: the port of
``s2p_tpu/utils/plotting.py``.

Capability contract (reference: rlkit/visualization/plot_util.py — load
experiment folders, filter by variant, smooth, plot mean±std across seeds;
539 LoC of which the S2P workflows use the load/smooth/compare core).
Matplotlib (Agg backend) renders to files; nothing here touches the hot
path."""

from __future__ import annotations

import glob
import json
import os.path as osp
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from s2p_tpu_torch.testing.csv_util import get_exp


class Experiment:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.progress = get_exp(osp.join(run_dir, "progress.csv"))
        variant_path = osp.join(run_dir, "variant.json")
        self.variant: Dict[str, Any] = {}
        if osp.exists(variant_path):
            with open(variant_path) as f:
                self.variant = json.load(f)

    def column(self, key: str) -> np.ndarray:
        vals = []
        for row in self.progress:
            try:
                vals.append(float(row[key]))
            except (KeyError, ValueError):
                vals.append(np.nan)
        return np.asarray(vals)


def load_exps(base_dir: str, pattern: str = "**/progress.csv") -> List[Experiment]:
    return [
        Experiment(osp.dirname(p))
        for p in sorted(glob.glob(osp.join(base_dir, pattern), recursive=True))
    ]


def filter_exps(exps: Sequence[Experiment],
                predicate: Callable[[Dict[str, Any]], bool]) -> List[Experiment]:
    return [e for e in exps if predicate(e.variant)]


def smooth(y: np.ndarray, window: int = 1) -> np.ndarray:
    if window <= 1:
        return y
    kernel = np.ones(window) / window
    return np.convolve(y, kernel, mode="valid")


def plot_returns(
    runs: Sequence[Experiment],
    key: str = "eval/Average Returns",
    x_key: str = "epoch",
    smooth_window: int = 1,
    label: Optional[str] = None,
    save_path: Optional[str] = None,
    ax=None,
):
    """Mean±std across runs (seeds) of one metric; returns the axis.
    matplotlib is imported here, and where it is missing this raises."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    ys = [smooth(r.column(key), smooth_window) for r in runs]
    n = min(len(y) for y in ys)
    ys = np.stack([y[:n] for y in ys])
    x = runs[0].column(x_key)[: ys.shape[1]]
    mean, std = np.nanmean(ys, axis=0), np.nanstd(ys, axis=0)
    ax.plot(x, mean, label=label or key)
    ax.fill_between(x, mean - std, mean + std, alpha=0.25)
    ax.set_xlabel(x_key)
    ax.set_ylabel(key)
    if label:
        ax.legend()
    if save_path:
        ax.figure.savefig(save_path, bbox_inches="tight", dpi=120)
    return ax
