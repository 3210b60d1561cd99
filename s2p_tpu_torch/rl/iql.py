"""IQL trainer: expectile-regression offline RL.

The port of ``s2p_tpu/rl/iql.py``. One step, in the JAX package's order:

1. SLAC path: ``prepare_batch`` without gradients turns the window batch
   into (z, next_z, action, feature_action); state path: observations;
2. the critic loss: ``q_target = scale·r + (1 − d)·γ·V(next_z)``, both Qs
   against it, the expectile VF loss (``quantile``) against the target
   networks' min Q, and ``adv = min Q_target − V`` from the pre-update V;
3. the AWR policy loss ``−log π(a)·min(exp(adv/β), clip_score)``;
4. both Adam updates (each ``optax.adam``), gated by ``step % period``;
5. the soft target update from the **updated** critic when ``step %
   target_update_period == 0`` (so step 0 updates the targets);
6. in ``train``/``train_many``, the joint latent step after the RL step,
   on the latent the RL step used.

``train_many`` is a Python loop of that step with batches sampled on the
device (the JAX package scans). Every draw (batch indices, posterior noise)
comes from one ``torch.Generator`` on the trainer's device, seeded from
``seed + 1``; the latent step draws from the SLAC algorithm's own.
``eval_statistics`` has the JAX package's keys.

Data parallelism (``dp_group``, the mesh's data group): JAX replicates the
trainer's states and shards the batch over the mesh's data axis. Here
each rank steps on its part of the global batch with its own generator
(seeded per rank, ``rank_seed``); the critic's and the policy's gradients
are averaged over the ranks in one flat all-reduce before either Adam
steps, on every step whatever the update periods (so that the ranks stay
in lockstep), and the metrics after the step. Every loss and metric is a
batch mean, so the averaged step is the step on the global batch.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict
from s2p_tpu_torch.parallel.mesh import mean_metrics, rank_seed, sync_grads
from s2p_tpu_torch.rl.critics import CriticSLAC, q_subtree, soft_update
from s2p_tpu_torch.rl.state import (
    adam,
    jax_networks_state,
    load_networks_full_state,
    networks_full_state,
    networks_state_from_jax,
)
from s2p_tpu_torch.rl.scan_utils import train_many


class IQLTrainer:
    def __init__(self, policy: torch.nn.Module, critic: CriticSLAC, discount: float = 0.99,
                 reward_scale: float = 1.0, policy_lr: float = 1e-4, qf_lr: float = 3e-4,
                 quantile: float = 0.7, beta: float = 0.1, clip_score: Optional[float] = 100.0,
                 soft_target_tau: float = 0.005, target_update_period: int = 2,
                 policy_update_period: int = 1, q_update_period: int = 1,
                 reward_transform: Optional[Tuple[float, float]] = None,
                 terminal_transform: Optional[Tuple[float, float]] = None,
                 slac_algo=None, slac_policy_input_type: str = "feature_action",
                 slac_update_period: int = 1, freeze_slac: bool = False, seed: int = 0,
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
        self.discount, self.reward_scale = discount, reward_scale
        self.quantile, self.beta, self.clip_score = quantile, beta, clip_score
        self.soft_target_tau = soft_target_tau
        self.target_update_period = target_update_period
        self.policy_update_period = policy_update_period
        self.q_update_period = q_update_period
        self.reward_transform, self.terminal_transform = reward_transform, terminal_transform
        self.slac_algo = slac_algo
        self.slac_policy_input_type = slac_policy_input_type
        self.slac_update_period = slac_update_period
        self.freeze_slac = freeze_slac
        self._n_train_steps_total = 0
        self.eval_statistics: Dict[str, float] = {}
        self._need_stats = True

    # -- one step -------------------------------------------------------------
    def _step(self, batch: Mapping[str, torch.Tensor],
              prepare_noise: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        step = self._n_train_steps_total
        dtype = next(self.critic.parameters()).dtype
        get = lambda k: torch.as_tensor(batch[k], device=self.device).to(dtype)  # noqa: E731
        rewards, terminals = get("rewards").reshape(-1, 1), get("terminals").reshape(-1, 1)
        if self.reward_transform is not None:
            m, b = self.reward_transform
            rewards = m * rewards + b
        if self.terminal_transform is not None:
            m, b = self.terminal_transform
            terminals = m * terminals + b
        if self.slac_algo is not None:
            obs = torch.as_tensor(batch["observations"], device=self.device)
            z, next_z, actions, fa, _ = self.slac_algo.prepare_batch(
                obs, get("actions"), self.generator if prepare_noise is None else prepare_noise)
            policy_input = fa if self.slac_policy_input_type == "feature_action" else z
        else:
            z, next_z, actions = get("observations"), get("next_observations"), get("actions")
            policy_input = z

        q1, q2, vf = self.critic(z, actions)
        with torch.no_grad():
            next_vf = self.critic.value(next_z)
            q_target = self.reward_scale * rewards + (1.0 - terminals) * self.discount * next_vf
            q_pred = torch.minimum(self.target_q.qf1(z, actions), self.target_q.qf2(z, actions))
        qf1_loss = ((q1 - q_target) ** 2).mean()
        qf2_loss = ((q2 - q_target) ** 2).mean()
        vf_err = vf - q_pred
        vf_sign = (vf_err > 0).to(dtype)
        vf_weight = (1 - vf_sign) * self.quantile + vf_sign * (1 - self.quantile)
        vf_loss = (vf_weight * vf_err ** 2).mean()
        critic_loss = qf1_loss + qf2_loss + vf_loss
        adv = q_pred - vf.detach()

        logpp = self.policy(policy_input).log_prob(actions)  # [B], summed over the action
        exp_adv = torch.exp(adv / self.beta)
        if self.clip_score is not None:
            exp_adv = exp_adv.clamp(max=self.clip_score)
        weights = exp_adv[:, 0]
        policy_loss = (-logpp * weights).mean()

        self.critic_opt.zero_grad(set_to_none=True)
        self.policy_opt.zero_grad(set_to_none=True)
        (critic_loss + policy_loss).backward()  # disjoint parameters: two losses' gradients
        sync_grads([p.grad for net in (self.critic, self.policy) for p in net.parameters()
                    if p.grad is not None], self.dp_group)
        if step % self.q_update_period == 0:
            self.critic_opt.step()
        if step % self.policy_update_period == 0:
            self.policy_opt.step()
        if step % self.target_update_period == 0:
            soft_update(self.target_q.qf1, self.critic.qf1, self.soft_target_tau)
            soft_update(self.target_q.qf2, self.critic.qf2, self.soft_target_tau)
        metrics = dict(critic_loss=critic_loss, qf1_loss=qf1_loss, qf2_loss=qf2_loss,
                       vf_loss=vf_loss, q1_pred=q1.mean(), q2_pred=q2.mean(),
                       q_target=q_target.mean(), vf_pred=vf.mean(), policy_loss=policy_loss,
                       policy_logpp=logpp.mean(), awr_weights=weights.mean())
        return mean_metrics({k: v.detach() for k, v in metrics.items()}, self.dp_group)

    def _record(self, metrics: Dict[str, torch.Tensor]) -> None:
        if self._need_stats:
            self._need_stats = False
            self.eval_statistics = {k: float(v) for k, v in metrics.items()}

    # -- trainer protocol -----------------------------------------------------
    def train(self, batch: Mapping[str, Any],
              prepare_noise: Optional[Sequence[torch.Tensor]] = None,
              latent_draws: Optional[Tuple[torch.Tensor, Sequence[torch.Tensor]]] = None
              ) -> Dict[str, torch.Tensor]:
        """One step on ``batch``; with SLAC and an unfrozen latent, then one
        ELBO step on the SLAC buffer. ``prepare_noise`` (the posterior noise
        of ``prepare_batch``) and ``latent_draws`` (the ELBO step's slot
        indices and noise) replace the generators' draws. Returns the
        metrics as tensors on the device."""
        metrics = self._step(batch, prepare_noise)
        if (self.slac_algo is not None and not self.freeze_slac
                and self._n_train_steps_total % self.slac_update_period == 0):
            idx, noise = latent_draws if latent_draws is not None else (None, None)
            metrics.update(self.slac_algo.update_latent(idx=idx, noise=noise))
        self._n_train_steps_total += 1
        self._record(metrics)
        return metrics

    def train_many(self, num_steps: int, batch_size: int, buffer=None,
                   buffer_gen=None) -> Dict[str, torch.Tensor]:
        """``scan_utils.train_many``: ``num_steps`` steps with batches drawn
        on the device (SLAC windows, half from ``buffer_gen`` when given,
        and the joint latent step; or flat batches of a
        ``SimpleReplayBuffer``)."""
        return train_many(self, num_steps, batch_size, buffer, buffer_gen)

    def end_epoch(self, epoch: int) -> None:
        self._need_stats = True

    def get_diagnostics(self) -> Dict[str, float]:
        d = dict(self.eval_statistics)
        d["num train calls"] = float(self._n_train_steps_total)
        return d

    def get_snapshot(self) -> Dict[str, Any]:
        snap = dict(policy_params=jax_dense_tree_from_state_dict(self.policy.state_dict()),
                    critic_params=jax_dense_tree_from_state_dict(self.critic.state_dict()),
                    target_q=jax_dense_tree_from_state_dict(self.target_q.state_dict())["params"])
        if self.slac_algo is not None:
            snap["latent_params"] = self.slac_algo.jax_params()
        return snap

    # -- crash-recovery state (optimizer state included) ----------------------
    def full_state(self) -> Dict[str, Any]:
        return networks_full_state(self)

    def load_full_state(self, s: Mapping[str, Any]) -> None:
        load_networks_full_state(self, s)


# -- the JAX package's full_state ↔ the port's ---------------------------------

def iql_full_state_from_jax(trainer: IQLTrainer, s: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX ``IQLTrainer.full_state()`` (numpy leaves) as the port's
    ``full_state`` for ``trainer``; the generator state stays the
    trainer's (JAX keys do not map to it)."""
    return dict(networks_state_from_jax(trainer, s), rng=trainer.generator.get_state(),
                n_train_steps=int(np.asarray(s["n_train_steps"])))


def jax_iql_full_state(trainer: IQLTrainer) -> Dict[str, Any]:
    """The port's trainer state as the JAX ``full_state`` layout with numpy
    leaves; each optimizer state is ``{"count", "mu", "nu"}``."""
    return dict(jax_networks_state(trainer), n_train_steps=trainer._n_train_steps_total)
