"""Multitask replay buffers + a compact meta-RL loop: the port of
``s2p_tpu/data/multitask_buffer.py`` (plain numpy on the host over the
port's ``SimpleReplayBuffer``, the same draws).

Capability contracts:
- ``MultiTaskReplayBuffer`` (reference: rlkit/data_management/
  multitask_replay_buffer.py:10): one SimpleReplayBuffer per task,
  task-indexed adds and sampling (including multi-task batch stacks).
- ``SplitReplayBuffer`` (reference: split_buffer.py): route additions to a
  train/validation pair by probability.
- ``MetaRLAlgorithm`` (reference: rlkit/core/meta_rl_algorithm.py:22,
  PEARL-style, legacy/unused by the S2P scripts): per-iteration task
  sampling → per-task data collection → meta-training over task batches —
  kept as a compact loop with the same phase structure.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from s2p_tpu_torch.data.replay import SimpleReplayBuffer


class MultiTaskReplayBuffer:
    def __init__(self, max_replay_buffer_size: int, env, task_indices:
                 Sequence[int], **buffer_kwargs):
        obs_dim = int(np.prod(env.observation_space.shape))
        act_dim = int(np.prod(env.action_space.shape))
        self.task_buffers: Dict[int, SimpleReplayBuffer] = {
            idx: SimpleReplayBuffer(
                max_replay_buffer_size, obs_dim, act_dim, **buffer_kwargs
            )
            for idx in task_indices
        }

    def add_sample(self, task: int, *args, **kwargs) -> None:
        self.task_buffers[task].add_sample(*args, **kwargs)

    def add_path(self, task: int, path) -> None:
        self.task_buffers[task].add_path(path)

    def random_batch(self, task: int, batch_size: int, rng=None):
        return self.task_buffers[task].random_batch(batch_size, rng=rng)

    def sample_tasks_batch(self, tasks: Sequence[int], batch_size: int,
                           rng=None) -> Dict[str, np.ndarray]:
        """Stacked per-task batches [n_tasks, batch, ...]."""
        batches = [self.random_batch(t, batch_size, rng) for t in tasks]
        return {
            k: np.stack([b[k] for b in batches], axis=0) for k in batches[0]
        }

    def num_steps_can_sample(self, task: int) -> int:
        return self.task_buffers[task].num_steps_can_sample()


class SplitReplayBuffer:
    """Route each sample to train or validation (reference split_buffer.py)."""

    def __init__(self, train_replay_buffer, validation_replay_buffer,
                 fraction_paths_in_train: float = 0.9, seed: int = 0):
        self.train_replay_buffer = train_replay_buffer
        self.validation_replay_buffer = validation_replay_buffer
        self.fraction = fraction_paths_in_train
        self._rng = np.random.RandomState(seed)
        self._active = self.train_replay_buffer

    def add_sample(self, *args, **kwargs):
        self._active.add_sample(*args, **kwargs)

    def add_path(self, path):
        self._active.add_path(path)
        self._active = (
            self.train_replay_buffer
            if self._rng.random_sample() < self.fraction
            else self.validation_replay_buffer
        )

    def random_batch(self, *args, **kwargs):
        return self.train_replay_buffer.random_batch(*args, **kwargs)

    def __len__(self):
        return len(self.train_replay_buffer)


class MetaRLAlgorithm:
    """Compact PEARL-shaped loop: collect per sampled task, then meta-train
    over random task batches (reference core/meta_rl_algorithm.py phase
    structure; the posterior-sampling machinery lives in the trainer)."""

    def __init__(
        self,
        env,
        trainer,
        replay_buffer: MultiTaskReplayBuffer,
        collect_fn: Callable[[int], List[dict]],
        train_task_indices: Sequence[int],
        num_iterations: int = 10,
        num_tasks_per_itr: int = 5,
        num_train_steps_per_itr: int = 100,
        meta_batch: int = 4,
        batch_size: int = 64,
        seed: int = 0,
    ):
        self.env = env
        self.trainer = trainer
        self.replay_buffer = replay_buffer
        self.collect_fn = collect_fn
        self.train_task_indices = list(train_task_indices)
        self.num_iterations = num_iterations
        self.num_tasks_per_itr = num_tasks_per_itr
        self.num_train_steps_per_itr = num_train_steps_per_itr
        self.meta_batch = meta_batch
        self.batch_size = batch_size
        self._rng = np.random.RandomState(seed)

    def train(self) -> None:
        for itr in range(self.num_iterations):
            tasks = self._rng.choice(
                self.train_task_indices,
                size=min(self.num_tasks_per_itr, len(self.train_task_indices)),
                replace=False,
            )
            for task in tasks:
                self.env.reset_task(int(task))
                for path in self.collect_fn(int(task)):
                    self.replay_buffer.add_path(int(task), path)
            for _ in range(self.num_train_steps_per_itr):
                batch_tasks = self._rng.choice(
                    self.train_task_indices, size=self.meta_batch
                )
                batch = self.replay_buffer.sample_tasks_batch(
                    [int(t) for t in batch_tasks], self.batch_size, self._rng
                )
                self.trainer.train(batch)
            self.trainer.end_epoch(itr)
