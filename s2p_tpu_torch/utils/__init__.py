"""Training and experiment infrastructure of the port: seeding, checkpoints,
logging, timers and profiling, the launcher, sweeps, plotting and IO."""

from s2p_tpu_torch.utils.config import Config
from s2p_tpu_torch.utils.logging import Logger, logger, setup_logger
from s2p_tpu_torch.utils.timer import PhaseTimer, Timer
from s2p_tpu_torch.utils.seeding import RngStream, set_seed
from s2p_tpu_torch.utils.io import load_local_or_remote_file, save_pickle
from s2p_tpu_torch.utils.launcher import run_experiment, run_experiment_here, run_parallel_seeds
from s2p_tpu_torch.utils.sweep import (
    ConstantSchedule,
    DeterministicHyperparameterSweeper,
    LinearSchedule,
    PiecewiseLinearSchedule,
    RandomHyperparameterSweeper,
)

__all__ = [
    "Config",
    "Logger",
    "logger",
    "setup_logger",
    "PhaseTimer",
    "Timer",
    "set_seed",
    "RngStream",
    "load_local_or_remote_file",
    "save_pickle",
    "run_experiment",
    "run_experiment_here",
    "run_parallel_seeds",
    "ConstantSchedule",
    "DeterministicHyperparameterSweeper",
    "LinearSchedule",
    "PiecewiseLinearSchedule",
    "RandomHyperparameterSweeper",
]
