"""The online (step-wise) RL loop: the port of
``s2p_tpu/core/online_rl_algorithm.py``.

rlkit's ``core/online_rl_algorithm.py``: per epoch, the eval paths, then
single exploration steps (an ``MdpStepCollector``), each written to the
replay buffer and followed by ``num_trains_per_expl_step`` gradient steps;
``min_num_steps_before_training`` steps seed the buffer first. The epoch's
end and its logging are ``BatchRLAlgorithm``'s.
"""

from __future__ import annotations

from s2p_tpu_torch.core.batch_rl_algorithm import BatchRLAlgorithm


class OnlineRLAlgorithm(BatchRLAlgorithm):
    def __init__(
        self,
        trainer,
        exploration_env,
        evaluation_env,
        exploration_data_collector,  # MdpStepCollector
        evaluation_data_collector,  # MdpPathCollector
        replay_buffer,
        batch_size: int,
        max_path_length: int,
        num_epochs: int,
        num_eval_steps_per_epoch: int,
        num_expl_steps_per_train_loop: int,
        num_trains_per_expl_step: int = 1,
        num_train_loops_per_epoch: int = 1,
        min_num_steps_before_training: int = 0,
        **kwargs,
    ):
        super().__init__(
            trainer=trainer,
            exploration_env=exploration_env,
            evaluation_env=evaluation_env,
            exploration_data_collector=exploration_data_collector,
            evaluation_data_collector=evaluation_data_collector,
            replay_buffer=replay_buffer,
            batch_size=batch_size,
            max_path_length=max_path_length,
            num_epochs=num_epochs,
            num_eval_steps_per_epoch=num_eval_steps_per_epoch,
            num_expl_steps_per_train_loop=num_expl_steps_per_train_loop,
            num_trains_per_train_loop=num_trains_per_expl_step,
            num_train_loops_per_epoch=num_train_loops_per_epoch,
            min_num_steps_before_training=min_num_steps_before_training,
            start_epoch=0,
            **kwargs,
        )
        self.num_trains_per_expl_step = num_trains_per_expl_step

    def _train_epoch(self) -> None:
        if self.epoch == self._start_epoch and self.min_num_steps_before_training > 0:
            init_steps = self.expl_data_collector.collect_new_steps(
                self.max_path_length, self.min_num_steps_before_training,
                discard_incomplete_paths=False,
            )
            for s in init_steps:
                self.replay_buffer.add_sample(
                    s["observation"], s["action"], s["reward"],
                    s["terminal"], s["next_observation"],
                )
            self.expl_data_collector.end_epoch(-1)

        self.eval_data_collector.collect_new_paths(
            self.max_path_length, self.num_eval_steps_per_epoch,
            discard_incomplete_paths=True,
        )
        self.timer.stamp("evaluation sampling")

        for _ in range(self.num_train_loops_per_epoch):
            for _ in range(self.num_expl_steps_per_train_loop):
                s = self.expl_data_collector.collect_one_step(
                    self.max_path_length, discard_incomplete_paths=False
                )
                self.timer.stamp("exploration sampling")
                self.replay_buffer.add_sample(
                    s["observation"], s["action"], s["reward"],
                    s["terminal"], s["next_observation"],
                )
                self.timer.stamp("data storing")
                last = None
                for _ in range(self.num_trains_per_expl_step):
                    batch = self._random_batch(self.replay_buffer, self.batch_size)
                    last = self.trainer.train(batch)
                self.timer.stamp("training", sync=last)
