"""SAC trainer: twin-Q soft actor-critic with automatic entropy tuning.

The port of ``s2p_tpu/rl/sac.py`` (the trainer ``collect_dataset.py`` uses).
One step, in the JAX package's order:

1. α: one Adam step on ``−mean(log α · (log π + target entropy))``, with
   log π of actions drawn from the pre-update policy;
2. the policy: one Adam step on ``mean(α · log π − min Q)``, the same draw
   (one ε serves α and this loss) through the pre-update critic; only the
   policy's parameters get gradients;
3. the critic: next actions from the **updated** policy, the target
   ``scale·r + (1 − d)·γ·(min Q_target − α·log π′)``, both Qs against it;
4. the soft target update from the updated critic when ``step %
   target_update_period == 0``.

Every draw (the ε of step 1 and of step 3) comes from one
``torch.Generator`` on the trainer's device, seeded from ``seed + 1``, or is
given (``train(batch, draws=)``), so that a test can hand the port the
draws JAX makes from its keys. Temperatures are 0-dim tensors in the
networks' dtype; every Adam is ``optax.adam``. ``CQLTrainer`` extends this
class.

Data parallelism (``dp_group``, the mesh's data group): each rank steps on
its part of the global batch with its own generator (seeded per rank,
``rank_seed``). A step runs its updates in sequence, each on what the one
before it changed (the policy's loss sees the updated α; the critic's
target the updated policy), so each gradient is averaged over the ranks
(one flat all-reduce) right after it is taken and before its own Adam
step; the metrics are averaged after the step. Every loss and metric is a
batch mean, so the averaged step is the step on the global batch.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict
from s2p_tpu_torch.parallel.mesh import mean_metrics, rank_seed, sync_grads
from s2p_tpu_torch.rl.critics import CriticSLAC, q_subtree, soft_update
from s2p_tpu_torch.rl.state import adam

Draws = Optional[Mapping[str, Any]]


class SACTrainer:
    def __init__(self, policy: torch.nn.Module, critic: CriticSLAC, discount: float = 0.99,
                 reward_scale: float = 1.0, policy_lr: float = 3e-4, qf_lr: float = 3e-4,
                 soft_target_tau: float = 5e-3, target_update_period: int = 1,
                 use_automatic_entropy_tuning: bool = True,
                 target_entropy: Optional[float] = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 dp_group: Optional[dist.ProcessGroup] = None) -> None:
        self.device = torch.device(device)
        self.dp_group = dp_group
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed + 1, dp_group))
        self.policy = policy.to(self.device)
        self.critic = critic.to(self.device)
        self.target_q = q_subtree(self.critic)
        self.policy_opt = adam(self.policy.parameters(), policy_lr)
        self.critic_opt = adam(self.critic.parameters(), qf_lr)
        self.action_dim = policy.action_dim
        self.discount, self.reward_scale = discount, reward_scale
        self.soft_target_tau = soft_target_tau
        self.target_update_period = target_update_period
        self.use_automatic_entropy_tuning = use_automatic_entropy_tuning
        self.target_entropy = (target_entropy if target_entropy is not None
                               else -float(self.action_dim))
        self.log_alpha = torch.zeros((), device=self.device, dtype=self.dtype, requires_grad=True)
        self.alpha_opt = adam([self.log_alpha], policy_lr)
        self._n_train_steps_total = 0
        self.eval_statistics: Dict[str, float] = {}
        self._need_stats = True

    @property
    def dtype(self) -> torch.dtype:
        return next(self.critic.parameters()).dtype

    # -- pieces of a step -----------------------------------------------------
    def _drawer(self, draws: Draws):
        """``draw(name, shape)``: the given draw ``name`` on the trainer's
        device and dtype, or a fresh one from the generator (uniform in
        [−1, 1) for "random", standard normal otherwise)."""
        def draw(name: str, shape: Tuple[int, ...]) -> torch.Tensor:
            if draws is not None:
                return torch.as_tensor(draws[name]).to(self.device, self.dtype)
            kw = dict(generator=self.generator, device=self.device, dtype=self.dtype)
            if name == "random":
                return torch.rand(shape, **kw) * 2.0 - 1.0
            return torch.randn(shape, **kw)

        return draw

    def _batch_get(self, batch: Mapping[str, Any]):
        get = lambda k: torch.as_tensor(batch[k], device=self.device).to(self.dtype)  # noqa: E731
        return get, get("rewards").reshape(-1, 1), get("terminals").reshape(-1, 1)

    def _update_alpha(self, log_pi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam step of log α on the detached ``log_pi`` [B, 1]; returns
        (the updated α, the loss before the step)."""
        if not self.use_automatic_entropy_tuning:
            one = torch.ones((), device=self.device, dtype=self.dtype)
            return one, torch.zeros_like(one)
        alpha_loss = -(self.log_alpha * (log_pi + self.target_entropy)).mean()
        self.alpha_opt.zero_grad(set_to_none=True)
        alpha_loss.backward()
        self._sync_grads([self.log_alpha])
        self.alpha_opt.step()
        return self.log_alpha.detach().exp(), alpha_loss.detach()

    def _policy_step(self, loss: torch.Tensor) -> None:
        """An Adam step of the policy on ``loss``'s gradient with respect to
        the policy's parameters alone: a critic the loss passes through gets
        none (the JAX package differentiates the policy's parameters only)."""
        params = list(self.policy.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        self._sync_grads(params)
        self.policy_opt.step()

    def _sync_grads(self, params) -> None:
        """Average the gradients of ``params`` (those that have one) over the
        data-parallel ranks."""
        sync_grads([p.grad for p in params if p.grad is not None], self.dp_group)

    def _update_targets(self, step: int) -> None:
        if step % self.target_update_period == 0:
            soft_update(self.target_q.qf1, self.critic.qf1, self.soft_target_tau)
            soft_update(self.target_q.qf2, self.critic.qf2, self.soft_target_tau)

    # -- one step -------------------------------------------------------------
    def _step(self, batch: Mapping[str, Any], draws: Draws = None) -> Dict[str, torch.Tensor]:
        step = self._n_train_steps_total
        draw = self._drawer(draws)
        get, rewards, terminals = self._batch_get(batch)
        obs, actions, next_obs = get("observations"), get("actions"), get("next_observations")
        B = obs.shape[0]

        new_actions, log_pi = self.policy(obs).sample_and_log_prob(
            eps=draw("pi", (B, self.action_dim)))
        log_pi = log_pi[:, None]
        alpha, alpha_loss = self._update_alpha(log_pi.detach())
        q1_new, q2_new = self.critic.q_values(obs, new_actions)
        policy_loss = (alpha * log_pi - torch.minimum(q1_new, q2_new)).mean()
        self._policy_step(policy_loss)

        with torch.no_grad():
            next_actions, next_log_pi = self.policy(next_obs).sample_and_log_prob(
                eps=draw("next", (B, self.action_dim)))
            target_q_values = (torch.minimum(self.target_q.qf1(next_obs, next_actions),
                                             self.target_q.qf2(next_obs, next_actions))
                               - alpha * next_log_pi[:, None])
            q_target = (self.reward_scale * rewards
                        + (1.0 - terminals) * self.discount * target_q_values)
        q1, q2 = self.critic.q_values(obs, actions)
        qf1_loss = ((q1 - q_target) ** 2).mean()
        qf2_loss = ((q2 - q_target) ** 2).mean()
        critic_loss = qf1_loss + qf2_loss
        self.critic_opt.zero_grad(set_to_none=True)
        critic_loss.backward()
        self._sync_grads(self.critic.parameters())
        self.critic_opt.step()
        self._update_targets(step)
        metrics = dict(policy_loss=policy_loss, alpha=alpha, alpha_loss=alpha_loss,
                       log_pi=log_pi.mean(), critic_loss=critic_loss, qf1_loss=qf1_loss,
                       qf2_loss=qf2_loss, q1_pred=q1.mean(), q2_pred=q2.mean())
        return mean_metrics({k: v.detach() for k, v in metrics.items()}, self.dp_group)

    def _record(self, metrics: Dict[str, torch.Tensor]) -> None:
        if self._need_stats:
            self._need_stats = False
            self.eval_statistics = {k: float(v) for k, v in metrics.items()}

    # -- trainer protocol -----------------------------------------------------
    def train(self, batch: Mapping[str, Any], draws: Draws = None) -> Dict[str, torch.Tensor]:
        """One step on a flat transition batch; ``draws`` ({"pi", "next"},
        each [B, A]) replace the generator's. Returns the metrics as tensors
        on the device."""
        metrics = self._step(batch, draws)
        self._n_train_steps_total += 1
        self._record(metrics)
        return metrics

    def end_epoch(self, epoch: int) -> None:
        self._need_stats = True

    def get_diagnostics(self) -> Dict[str, float]:
        d = dict(self.eval_statistics)
        d["num train calls"] = float(self._n_train_steps_total)
        return d

    def get_snapshot(self) -> Dict[str, Any]:
        return dict(policy_params=jax_dense_tree_from_state_dict(self.policy.state_dict()),
                    critic_params=jax_dense_tree_from_state_dict(self.critic.state_dict()),
                    target_q=jax_dense_tree_from_state_dict(self.target_q.state_dict())["params"],
                    log_alpha=self.log_alpha.item())
