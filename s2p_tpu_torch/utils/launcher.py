"""Experiment launcher: the port of ``s2p_tpu/utils/launcher.py``.

``run_experiment_here`` seeds, creates the run directory with
``variant.json`` (configuring the module-level ``logger``), pickles the
launch arguments (``experiment.pkl``) and calls ``experiment(variant)``;
``run_parallel_seeds`` starts one process per seed, from the ``spawn``
context since CUDA does not survive a ``fork``, so the experiment function
must be importable (defined at a module's top level). The reference
staggers the starts to ease concurrent HDF5 loads; so does the port.
"""

from __future__ import annotations

import multiprocessing as mp
import os.path as osp
import time
from typing import Any, Callable, List, Mapping

from s2p_tpu_torch.utils.io import save_pickle
from s2p_tpu_torch.utils.logging import logger, setup_logger
from s2p_tpu_torch.utils.seeding import set_seed


def run_experiment_here(
    experiment_function: Callable[[Mapping[str, Any]], Any],
    variant: Mapping[str, Any],
    exp_name: str = "experiment",
    seed: int = 0,
    base_log_dir: str = "./logs",
    snapshot_mode: str = "gap_and_last",
    snapshot_gap: int = 10,
) -> Any:
    set_seed(seed)
    variant = dict(variant)
    variant.setdefault("seed", seed)
    variant.setdefault("exp_name", exp_name)
    _, log_dir = setup_logger(exp_name, variant=variant, base_log_dir=base_log_dir, seed=seed,
                              snapshot_mode=snapshot_mode, snapshot_gap=snapshot_gap,
                              log=logger)
    save_pickle(dict(variant=variant, exp_name=exp_name, seed=seed),
                osp.join(log_dir, "experiment.pkl"))
    try:
        return experiment_function(variant)
    finally:
        logger.close()


def run_experiment(
    experiment_function: Callable[[Mapping[str, Any]], Any],
    variant: Mapping[str, Any],
    mode: str = "here_no_doodad",
    **kwargs: Any,
) -> Any:
    if mode != "here_no_doodad":
        raise ValueError(f"mode {mode!r} not supported (the reference's shipped scripts use "
                         "only here_no_doodad)")
    return run_experiment_here(experiment_function, variant, **kwargs)


def run_parallel_seeds(
    experiment_function: Callable[[Mapping[str, Any]], Any],
    variant: Mapping[str, Any],
    seeds: List[int],
    exp_name: str = "experiment",
    base_log_dir: str = "./logs",
    stagger_seconds: float = 10.0,
) -> List[mp.Process]:
    """One process per seed, started ``stagger_seconds`` apart; returns
    the started processes (the caller joins them)."""
    ctx = mp.get_context("spawn")
    procs = []
    for i, seed in enumerate(seeds):
        p = ctx.Process(
            target=run_experiment_here,
            args=(experiment_function, dict(variant)),
            kwargs=dict(exp_name=exp_name, seed=seed, base_log_dir=base_log_dir),
        )
        p.start()
        procs.append(p)
        if i < len(seeds) - 1 and stagger_seconds:
            time.sleep(stagger_seconds)
    return procs
