"""The offline loop of gradient steps over a fixed buffer.

The port of ``s2p_tpu/core/simple_offline_rl_algorithm.py``: no environment,
``num_epochs`` × ``num_batches_per_epoch`` trainer steps, the trainer's
diagnostics and the epoch's times logged once per epoch.

Batches come from ``data.replay.random_batch``, which calls the buffer as
its ``sampling_style`` says: ``"generator"`` (the SLAC sequence buffer)
draws on the device from a ``torch.Generator``, ``"rng"`` (the flat
buffer) on the host from a numpy ``RandomState``. Both are seeded from
``seed``; the generator lives on the trainer's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from s2p_tpu_torch.data.replay import random_batch
from s2p_tpu_torch.utils.logging import Logger
from s2p_tpu_torch.utils.logging import logger as global_logger
from s2p_tpu_torch.utils.timer import Timer, block_until_ready


class SimpleOfflineRlAlgorithm:
    def __init__(self, trainer, replay_buffer, batch_size: int, num_epochs: int,
                 num_batches_per_epoch: int, logger: Optional[Logger] = None,
                 seed: int = 0) -> None:
        self.trainer = trainer
        self.replay_buffer = replay_buffer
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.num_batches_per_epoch = num_batches_per_epoch
        self.logger = logger or global_logger
        self.timer = Timer()
        self._rng = np.random.RandomState(seed)
        self._generator = torch.Generator(device=trainer.device).manual_seed(seed)

    def _random_batch(self):
        return random_batch(self.replay_buffer, self.batch_size, self._generator, self._rng)

    def train(self) -> None:
        for epoch in range(self.num_epochs):
            self.timer.start_epoch()
            self.timer.start_timer("training")
            last = None
            for _ in range(self.num_batches_per_epoch):
                last = self.trainer.train(self._random_batch())
            block_until_ready(last)
            self.timer.stop_timer("training")
            self.logger.record_tabular("epoch", epoch)
            self.logger.record_dict(
                {k: float(v) for k, v in self.trainer.get_diagnostics().items()},
                prefix="trainer/")
            self.logger.record_dict({f"time/{k}": v for k, v in self.timer.get_times().items()})
            self.logger.dump_tabular()
            self.trainer.end_epoch(epoch)
