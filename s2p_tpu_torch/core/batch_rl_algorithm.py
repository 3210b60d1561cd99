"""The batch RL loop: the port of ``s2p_tpu/core/batch_rl_algorithm.py``.

rlkit's ``core/rl_algorithm.py`` and ``core/batch_rl_algorithm.py``:

- epochs ``[start_epoch, num_epochs)``; negative epochs are offline (no
  buffer writes, a one-step exploration path);
- per epoch: eval paths (every ``eval_period`` epochs, the first and the
  last always), then per train loop the exploration paths, their buffer
  writes (online, non-SLAC only) and ``num_trains_per_train_loop``
  ``trainer.train`` calls;
- with a generated-data buffer, each batch is half real and half
  generated, concatenated per key with ``torch.cat`` on the buffers'
  device;
- ``scan_training``: one ``trainer.train_many`` call per train loop, when
  the trainer has it and every buffer is ``scannable``;
- ``_end_epoch``: a snapshot every ``snapshot_gap`` epochs through the
  logger, the frozen progress.csv columns (buffer, trainer, exploration and
  evaluation diagnostics, per-path stats, ``eval/is_fresh``, the
  ``PhaseTimer``'s ``time/`` columns), ``rewards_list.pkl``, then the
  post-epoch hooks.

Batches come from ``data.replay.random_batch``, which calls the buffer as
its ``sampling_style`` says: ``"generator"`` (the SLAC sequence buffer)
with a ``torch.Generator`` on the trainer's device, ``"rng"`` (flat
buffers) with a numpy ``RandomState``, both seeded from ``seed``.
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from s2p_tpu_torch.data.replay import random_batch
from s2p_tpu_torch.utils.logging import Logger
from s2p_tpu_torch.utils.logging import logger as global_logger
from s2p_tpu_torch.utils.stats import get_generic_path_information
from s2p_tpu_torch.utils.timer import PhaseTimer


class BatchRLAlgorithm:
    def __init__(
        self,
        trainer,
        exploration_env,
        evaluation_env,
        exploration_data_collector,
        evaluation_data_collector,
        replay_buffer,
        batch_size: int,
        max_path_length: int,
        num_epochs: int,
        num_eval_steps_per_epoch: int,
        num_expl_steps_per_train_loop: int,
        num_trains_per_train_loop: int,
        num_train_loops_per_epoch: int = 1,
        min_num_steps_before_training: int = 0,
        start_epoch: int = 0,
        replay_buffer_gen=None,
        slac_representation: bool = False,
        logger: Optional[Logger] = None,
        snapshot_gap: int = 10,
        seed: int = 0,
        scan_training: bool = False,
        eval_period: int = 1,
    ):
        self.trainer = trainer
        self.expl_env = exploration_env
        self.eval_env = evaluation_env
        self.expl_data_collector = exploration_data_collector
        self.eval_data_collector = evaluation_data_collector
        self.replay_buffer = replay_buffer
        self.replay_buffer_gen = replay_buffer_gen
        self.batch_size = batch_size
        self.max_path_length = max_path_length
        self.num_epochs = num_epochs
        self.num_eval_steps_per_epoch = num_eval_steps_per_epoch
        self.num_expl_steps_per_train_loop = num_expl_steps_per_train_loop
        self.num_trains_per_train_loop = num_trains_per_train_loop
        self.num_train_loops_per_epoch = num_train_loops_per_epoch
        self.min_num_steps_before_training = min_num_steps_before_training
        self._start_epoch = start_epoch
        self.slac_representation = slac_representation
        self.logger = logger or global_logger
        self.snapshot_gap = snapshot_gap
        self.post_epoch_funcs: List[Callable] = []
        # the whole train loop in one trainer.train_many call, batches drawn
        # on the device (dual-buffer configurations sample 50/50 inside it)
        self.scan_training = (
            scan_training
            and hasattr(trainer, "train_many")
            and getattr(replay_buffer, "scannable", False)
            and (replay_buffer_gen is None
                 or getattr(replay_buffer_gen, "scannable", False))
        )
        # eval rollouts cost a host round trip per env step; eval_period > 1
        # collects them every N epochs and carries the stats forward between
        # (the reference collects every epoch)
        self.eval_period = max(1, eval_period)
        self._last_eval_stats: Dict[str, Any] = {}
        self._last_eval_diag: Dict[str, Any] = {}
        self.timer = PhaseTimer()
        self.epoch = start_epoch
        self.offline_rl = start_epoch < 0
        self._rewards_log_list: List[np.ndarray] = []
        self._sample_rng = np.random.RandomState(seed)
        self._generator = torch.Generator(device=trainer.device).manual_seed(seed)

    # -- sampling dispatch --------------------------------------------------
    def _random_batch(self, buffer, batch_size: int) -> Dict[str, Any]:
        return random_batch(buffer, batch_size, self._generator, self._sample_rng)

    # -- main loop ----------------------------------------------------------
    def train(self) -> None:
        """Negative epochs are offline, the others online."""
        for self.epoch in range(self._start_epoch, self.num_epochs):
            self.offline_rl = self.epoch < 0
            self._train_epoch()
            self._end_epoch(self.epoch)

    def _train_epoch(self) -> None:
        if self.epoch == 0 and self.min_num_steps_before_training > 0:
            init_paths = self.expl_data_collector.collect_new_paths(
                self.max_path_length, self.min_num_steps_before_training,
                discard_incomplete_paths=False,
            )
            if not self.offline_rl and not self.slac_representation:
                self.replay_buffer.add_paths(init_paths)
            self.expl_data_collector.end_epoch(-1)

        # relative to start_epoch, so that the first epoch always evaluates:
        # the first csv dump freezes the header, eval columns included
        if ((self.epoch - self._start_epoch) % self.eval_period == 0
                or self.epoch == self.num_epochs - 1):
            self.eval_data_collector.collect_new_paths(
                self.max_path_length, self.num_eval_steps_per_epoch,
                discard_incomplete_paths=True,
            )
        self.timer.stamp("evaluation sampling")

        for _ in range(self.num_train_loops_per_epoch):
            new_paths = self.expl_data_collector.collect_new_paths(
                self.max_path_length,
                self.num_expl_steps_per_train_loop if not self.offline_rl else 1,
                discard_incomplete_paths=False,
            )
            self.timer.stamp("exploration sampling")
            if not self.offline_rl and not self.slac_representation:
                self.replay_buffer.add_paths(new_paths)
            self.timer.stamp("data storing")

            if self.scan_training:
                last_metrics = self.trainer.train_many(
                    self.num_trains_per_train_loop, self.batch_size,
                    buffer=self.replay_buffer,
                    buffer_gen=self.replay_buffer_gen,
                )
                self.timer.stamp("training", sync=last_metrics)
                continue
            last_metrics = None
            for _ in range(self.num_trains_per_train_loop):
                if self.replay_buffer_gen is not None:
                    # half real, half generated per gradient step; the
                    # trainers take one concatenated batch
                    half = self.batch_size // 2
                    batch = self._random_batch(self.replay_buffer, half)
                    batch_gen = self._random_batch(self.replay_buffer_gen,
                                                   self.batch_size - half)
                    batch = {k: torch.cat([torch.as_tensor(v), torch.as_tensor(batch_gen[k])])
                             for k, v in batch.items()}
                else:
                    batch = self._random_batch(self.replay_buffer, self.batch_size)
                last_metrics = self.trainer.train(batch)
            self.timer.stamp("training", sync=last_metrics)

    # -- epoch lifecycle ----------------------------------------------------
    def _end_epoch(self, epoch: int) -> None:
        if epoch % self.snapshot_gap == 0:
            self.logger.save_itr_params(epoch, self.trainer.get_snapshot())
        self.timer.stamp("saving")
        self._log_stats(epoch)
        self.expl_data_collector.end_epoch(epoch)
        self.eval_data_collector.end_epoch(epoch)
        self.replay_buffer.end_epoch(epoch)
        self.trainer.end_epoch(epoch)
        for fn in self.post_epoch_funcs:
            fn(self, epoch)

    def _log_stats(self, epoch: int) -> None:
        log = self.logger
        log.log(f"Epoch {epoch} finished")
        log.record_tabular("epoch", epoch)
        log.record_dict(self.replay_buffer.get_diagnostics(), prefix="replay_buffer/")
        # in key order, as the JAX loop's device_get of the dict gives them
        log.record_dict({k: float(v) for k, v in sorted(self.trainer.get_diagnostics().items())},
                        prefix="trainer/")
        log.record_dict(self.expl_data_collector.get_diagnostics(), prefix="expl/")
        expl_paths = self.expl_data_collector.get_epoch_paths()
        log.record_dict(get_generic_path_information(expl_paths), prefix="expl/")

        eval_paths = self.eval_data_collector.get_epoch_paths()
        eval_diag = dict(self.eval_data_collector.get_diagnostics())
        if eval_paths:
            self._last_eval_diag = eval_diag
        else:
            # path-length stats exist only on epochs with fresh eval paths:
            # backfill them from the last eval, as the frozen header needs
            eval_diag = {**self._last_eval_diag, **eval_diag}
        log.record_dict(eval_diag, prefix="eval/")
        if eval_paths:
            rewards = [np.asarray(p["rewards"]).ravel() for p in eval_paths]
            if len({len(r) for r in rewards}) == 1:
                self._rewards_log_list.append(np.stack(rewards, axis=0))
            if log.log_dir is not None:
                with open(osp.join(log.log_dir, "rewards_list.pkl"), "wb") as f:
                    pickle.dump(self._rewards_log_list, f)
        eval_stats = get_generic_path_information(eval_paths)
        if eval_paths:
            self._last_eval_stats = eval_stats
        else:
            # eval_period > 1: repeat the last measured stats, marked stale
            # by eval/is_fresh, so the frozen key set stays filled
            eval_stats = self._last_eval_stats
        log.record_dict(eval_stats, prefix="eval/")
        log.record_tabular("eval/is_fresh", int(bool(eval_paths)))

        self.timer.stamp("logging")
        log.record_dict(self.timer.end_epoch())
        log.record_tabular("Epoch", epoch)
        log.dump_tabular()
