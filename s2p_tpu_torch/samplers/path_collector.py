"""Path collector: the port of ``s2p_tpu/samplers/path_collector.py``.

Accumulate rollouts until a step budget is spent (rlkit's
``data_collector/path_collector.py``): each rollout capped at
``min(max_path_length, budget left)``, the discard-incomplete rule, the
epoch's path deque, the diagnostics and a snapshot of the policy (and env).

The diagnostics keys ("num steps total", "num paths total", "path length"
stats) are part of the frozen progress.csv contract. ``EpochPathLog`` is
shared with the step collector.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Optional

from s2p_tpu_torch.samplers.rollout import rollout as default_rollout
from s2p_tpu_torch.utils.stats import create_stats_ordered_dict


class EpochPathLog:
    """Per-epoch path deque + lifetime step/path counters, rendered into
    the diagnostics keys the frozen csv header expects. Shared by the
    path- and step-granular collectors."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self.paths: deque = deque(maxlen=capacity)
        self.lifetime_steps = 0
        self.lifetime_paths = 0

    def record(self, path: dict) -> None:
        """Lifetime step totals count kept paths only (reference
        semantics for both collectors)."""
        self.paths.append(path)
        self.lifetime_paths += 1
        self.lifetime_steps += len(path["actions"])

    def clear_epoch(self) -> None:
        self.paths = deque(maxlen=self.capacity)

    def diagnostics(self) -> OrderedDict:
        out = OrderedDict()
        out["num steps total"] = self.lifetime_steps
        out["num paths total"] = self.lifetime_paths
        out.update(create_stats_ordered_dict(
            "path length", [len(p["actions"]) for p in self.paths],
            always_show_all_stats=True,
        ))
        return out


class MdpPathCollector:
    """Collects whole rollouts until a step budget is spent.

    A trailing rollout that hits neither the env's terminal nor the full
    ``max_path_length`` (i.e. it was clamped by the remaining budget) is
    dropped when ``discard_incomplete_paths`` — eval protocols must not
    average over truncated returns.
    """

    def __init__(
        self,
        env,
        policy,
        max_num_epoch_paths_saved: Optional[int] = None,
        render: bool = False,
        render_kwargs: Optional[dict] = None,
        rollout_fn: Callable = default_rollout,
        save_env_in_snapshot: bool = True,
        slac_algo=None,
        slac_policy_input_type: Optional[str] = None,
        slac_obs_reset_w_same_obs: bool = False,
    ):
        self.env = env
        self.policy = policy
        self.log = EpochPathLog(max_num_epoch_paths_saved)
        self.save_env_in_snapshot = save_env_in_snapshot
        self._rollout_kwargs = dict(
            render=render,
            render_kwargs=render_kwargs or {},
            slac_algo=slac_algo,
            slac_policy_input_type=slac_policy_input_type,
            slac_obs_reset_w_same_obs=slac_obs_reset_w_same_obs,
        )
        self._rollout_fn = rollout_fn

    def _one_rollout(self, length_cap: int) -> dict:
        return self._rollout_fn(
            self.env, self.policy, max_path_length=length_cap,
            **self._rollout_kwargs,
        )

    def collect_new_paths(self, max_path_length: int, num_steps: int,
                          discard_incomplete_paths: bool) -> list:
        collected, budget = [], num_steps
        while budget > 0:
            path = self._one_rollout(min(max_path_length, budget))
            n = len(path["actions"])
            truncated_by_budget = (
                n != max_path_length and not path["dones"][-1]
            )
            if truncated_by_budget and discard_incomplete_paths:
                break
            budget -= n
            collected.append(path)
        for path in collected:
            self.log.record(path)
        return collected

    def get_epoch_paths(self):
        return self.log.paths

    def end_epoch(self, epoch: int) -> None:
        self.log.clear_epoch()

    def get_diagnostics(self) -> OrderedDict:
        return self.log.diagnostics()

    def get_snapshot(self) -> dict:
        snap = dict(policy=self.policy)
        if self.save_env_in_snapshot:
            snap["env"] = self.env
        return snap
