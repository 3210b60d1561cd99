"""CQL trainer: the SAC actor with a conservative twin-Q critic.

The port of ``s2p_tpu/rl/cql.py``, the trainer behind ``run_cql_image.sh``.
One step, in the JAX package's order:

1. SLAC path: ``prepare_batch`` without gradients turns the window batch
   into (z, next_z, action, feature_action, next_feature_action); state
   path: observations;
2. α, then the policy (``SACTrainer``'s steps, one ε for both): before
   ``policy_eval_start`` steps the policy loss is the BC warm-up
   ``mean(α·log π − log π(a_data))``, after it SAC's through the pre-update
   critic;
3. from the **updated** policy: the next actions of the target, and N
   actions per sample for the current and the next input, each input
   repeated N times in place (``repeat_interleave``, JAX's ``jnp.repeat``);
4. the critic: both Qs against the target plus the CQL penalty over N
   uniform actions in [−1, 1) and the 2N policy actions,
   ``min_q_weight·(temp·mean logsumexp(Q/temp) − mean Q(s, a_data))``;
   ``min_q_version`` 3 subtracts the importance densities (log 0.5^A and
   the detached log π's), another version concatenates Q(s, a_data)
   instead. The data Q and the 3N tiled evaluations run as one critic call
   over B·(3N + 1) rows. With the Lagrange term, ``α′ = clip(exp(log α′), 0,
   1e6)`` multiplies ``(penalty − lagrange_thresh)`` and log α′ takes an Adam
   step on −0.5 × its gradient of the critic loss;
5. the soft target update when ``step % target_update_period == 0``;
6. in ``train``/``train_many``, the joint latent step after the RL step.

Every draw comes from the trainer's generator or is given: ``train(batch,
draws=)`` takes ``posterior`` (the posterior noise of ``prepare_batch``),
``pi`` and ``next`` ([B, A]), ``random``, ``pi_tiled`` and ``next_tiled``
([B·N, A]), JAX's keys 0–5 of a step.

Data parallelism (``dp_group``) as ``SACTrainer`` has it: α's, the
policy's and then the critic's gradient (with α′'s, from the same
backward) are each averaged over the ranks before their own Adam step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from s2p_tpu_torch.parallel.mesh import mean_metrics
from s2p_tpu_torch.rl.critics import CriticSLAC
from s2p_tpu_torch.rl.sac import Draws, SACTrainer
from s2p_tpu_torch.rl.scan_utils import train_many
from s2p_tpu_torch.rl.state import (
    adam,
    adam_state_from_optax,
    adam_state_to_numpy,
    jax_networks_state,
    load_networks_full_state,
    networks_full_state,
    networks_state_from_jax,
)


class CQLTrainer(SACTrainer):
    def __init__(self, policy: torch.nn.Module, critic: CriticSLAC, discount: float = 0.99,
                 reward_scale: float = 1.0, policy_lr: float = 1e-4, qf_lr: float = 3e-4,
                 soft_target_tau: float = 5e-3, target_update_period: int = 1,
                 use_automatic_entropy_tuning: bool = True,
                 target_entropy: Optional[float] = None, policy_eval_start: int = 40_000,
                 temp: float = 1.0, min_q_version: int = 3, min_q_weight: float = 5.0,
                 with_lagrange: bool = False, lagrange_thresh: float = -1.0,
                 num_random: int = 10, deterministic_backup: bool = False, slac_algo=None,
                 slac_policy_input_type: str = "feature_action", slac_update_period: int = 1,
                 freeze_slac: bool = False, seed: int = 0,
                 device: str | torch.device = "cuda",
                 dp_group: Optional[dist.ProcessGroup] = None) -> None:
        super().__init__(policy, critic, discount, reward_scale, policy_lr, qf_lr,
                         soft_target_tau, target_update_period, use_automatic_entropy_tuning,
                         target_entropy, seed, device, dp_group)
        self.policy_eval_start = policy_eval_start
        self.temp, self.min_q_version, self.min_q_weight = temp, min_q_version, min_q_weight
        self.with_lagrange, self.target_action_gap = with_lagrange, lagrange_thresh
        self.num_random = num_random
        self.deterministic_backup = deterministic_backup
        self.slac_algo = slac_algo
        self.slac_policy_input_type = slac_policy_input_type
        self.slac_update_period = slac_update_period
        self.freeze_slac = freeze_slac
        self.log_alpha_prime = torch.zeros((), device=self.device, dtype=self.dtype,
                                           requires_grad=True)
        self.alpha_prime_opt = adam([self.log_alpha_prime], qf_lr)

    def _policy_actions(self, obs: torch.Tensor, eps: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """N actions per row of ``obs`` (rows repeated in place) and their
        log π as [B, N, 1]."""
        actions, log_pi = self.policy(obs.repeat_interleave(self.num_random, 0)) \
            .sample_and_log_prob(eps=eps)
        return actions, log_pi.reshape(obs.shape[0], self.num_random, 1)

    # -- one step -------------------------------------------------------------
    def _step(self, batch: Mapping[str, Any], draws: Draws = None) -> Dict[str, torch.Tensor]:
        step = self._n_train_steps_total
        draw = self._drawer(draws)
        get, rewards, terminals = self._batch_get(batch)
        if self.slac_algo is not None:
            obs = torch.as_tensor(batch["observations"], device=self.device)
            noise = (self.generator if draws is None
                     else [t.to(self.device, self.dtype) for t in draws["posterior"]])
            z, next_z, actions, fa, n_fa = self.slac_algo.prepare_batch(obs, get("actions"), noise)
            policy_input, policy_next_input = ((fa, n_fa)
                                               if self.slac_policy_input_type == "feature_action"
                                               else (z, next_z))
        else:
            z, next_z, actions = get("observations"), get("next_observations"), get("actions")
            policy_input, policy_next_input = z, next_z
        B, N, A = z.shape[0], self.num_random, self.action_dim

        dist = self.policy(policy_input)
        new_actions, log_pi = dist.sample_and_log_prob(eps=draw("pi", (B, A)))
        log_pi = log_pi[:, None]
        alpha, alpha_loss = self._update_alpha(log_pi.detach())
        if step < self.policy_eval_start:  # the BC warm-up
            policy_loss = (alpha * log_pi - dist.log_prob(actions)[:, None]).mean()
        else:
            q1_new, q2_new = self.critic.q_values(z, new_actions)
            policy_loss = (alpha * log_pi - torch.minimum(q1_new, q2_new)).mean()
        self._policy_step(policy_loss)

        with torch.no_grad():  # from the updated policy
            next_actions, next_log_pi = self.policy(policy_next_input).sample_and_log_prob(
                eps=draw("next", (B, A)))
            target_q_values = torch.minimum(self.target_q.qf1(next_z, next_actions),
                                            self.target_q.qf2(next_z, next_actions))
            if not self.deterministic_backup:
                target_q_values = target_q_values - alpha * next_log_pi[:, None]
            q_target = (self.reward_scale * rewards
                        + (1.0 - terminals) * self.discount * target_q_values)
            rand_actions = draw("random", (B * N, A))
            curr_actions, curr_log_pis = self._policy_actions(policy_input,
                                                              draw("pi_tiled", (B * N, A)))
            tiled_next_actions, next_log_pis = self._policy_actions(
                policy_next_input, draw("next_tiled", (B * N, A)))

        z_tiled = z.repeat_interleave(N, 0)
        q1_all, q2_all = self.critic.q_values(
            torch.cat([z, z_tiled, z_tiled, z_tiled]),
            torch.cat([actions, rand_actions, curr_actions, tiled_next_actions]))
        q1_pred, q2_pred = q1_all[:B], q2_all[:B]
        qf1_loss = ((q1_pred - q_target) ** 2).mean()
        qf2_loss = ((q2_pred - q_target) ** 2).mean()

        def penalty(q_all: torch.Tensor, q_pred: torch.Tensor):
            q_rand, q_curr, q_next = q_all[B:].reshape(3, B, N, 1).unbind(0)
            if self.min_q_version == 3:
                random_density = math.log(0.5 ** A)
                cat_q = torch.cat([q_rand - random_density, q_next - next_log_pis,
                                   q_curr - curr_log_pis], dim=1)
            else:
                cat_q = torch.cat([q_rand, q_pred[:, None], q_next, q_curr], dim=1)
            min_qf = (torch.logsumexp(cat_q / self.temp, dim=1).mean()
                      * self.min_q_weight * self.temp - q_pred.mean() * self.min_q_weight)
            return min_qf, cat_q

        min_qf1, cat_q1 = penalty(q1_all, q1_pred)
        min_qf2, _ = penalty(q2_all, q2_pred)
        if self.with_lagrange:
            alpha_prime = self.log_alpha_prime.exp().clamp(0.0, 1e6)
            min_qf1 = alpha_prime * (min_qf1 - self.target_action_gap)
            min_qf2 = alpha_prime * (min_qf2 - self.target_action_gap)
        critic_loss = qf1_loss + qf2_loss + min_qf1 + min_qf2
        self.critic_opt.zero_grad(set_to_none=True)
        self.alpha_prime_opt.zero_grad(set_to_none=True)
        critic_loss.backward()
        self._sync_grads([*self.critic.parameters(), self.log_alpha_prime])
        self.critic_opt.step()
        if self.with_lagrange:  # α′ ascends the thresholded penalty
            self.log_alpha_prime.grad.mul_(-0.5)
            self.alpha_prime_opt.step()
        self._update_targets(step)

        metrics = dict(critic_loss=critic_loss, qf1_loss=qf1_loss, qf2_loss=qf2_loss,
                       min_qf1_loss=min_qf1, min_qf2_loss=min_qf2, q1_pred=q1_pred.mean(),
                       q2_pred=q2_pred.mean(), q_target=q_target.mean(),
                       std_q1=cat_q1.std(dim=1, correction=0).mean(), policy_loss=policy_loss,
                       log_pi=log_pi.mean(), alpha=alpha, alpha_loss=alpha_loss)
        if self.with_lagrange:
            metrics["alpha_prime"] = self.log_alpha_prime.exp().clamp(0.0, 1e6)
        return mean_metrics({k: v.detach() for k, v in metrics.items()}, self.dp_group)

    # -- trainer protocol -----------------------------------------------------
    def train(self, batch: Mapping[str, Any], draws: Draws = None,
              latent_draws: Optional[Tuple[torch.Tensor, Sequence[torch.Tensor]]] = None
              ) -> Dict[str, torch.Tensor]:
        """One step on ``batch``; with SLAC and an unfrozen latent, then one
        ELBO step on the SLAC buffer. ``draws`` (the module docstring's six)
        and ``latent_draws`` (the ELBO step's slot indices and noise) replace
        the generators' draws. Returns the metrics as tensors on the
        device."""
        metrics = self._step(batch, draws)
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

    def get_snapshot(self) -> Dict[str, Any]:
        snap = super().get_snapshot()
        if self.slac_algo is not None:
            snap["latent_params"] = self.slac_algo.jax_params()
        return snap

    # -- crash-recovery state (optimizer and temperature state included) -----
    def full_state(self) -> Dict[str, Any]:
        return dict(networks_full_state(self), log_alpha=self.log_alpha.detach().clone(),
                    alpha_opt=self.alpha_opt.state_dict(),
                    log_alpha_prime=self.log_alpha_prime.detach().clone(),
                    alpha_prime_opt=self.alpha_prime_opt.state_dict())

    def load_full_state(self, s: Mapping[str, Any]) -> None:
        load_networks_full_state(self, s)
        with torch.no_grad():
            self.log_alpha.copy_(torch.as_tensor(s["log_alpha"]))
            self.log_alpha_prime.copy_(torch.as_tensor(s["log_alpha_prime"]))
        self.alpha_opt.load_state_dict(s["alpha_opt"])
        self.alpha_prime_opt.load_state_dict(s["alpha_prime_opt"])


# -- the JAX package's full_state ↔ the port's ---------------------------------

_TEMPERATURES = (("log_alpha", "alpha_opt"), ("log_alpha_prime", "alpha_prime_opt"))


def cql_full_state_from_jax(trainer: CQLTrainer, s: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX ``CQLTrainer.full_state()`` (numpy leaves) as the port's
    ``full_state`` for ``trainer``: networks, both temperatures and every
    Adam state; the generator state stays the trainer's (JAX keys do not map
    to it)."""
    out = dict(networks_state_from_jax(trainer, s), rng=trainer.generator.get_state(),
               n_train_steps=int(np.asarray(s["n_train_steps"])))
    for name, opt in _TEMPERATURES:
        out[name] = torch.tensor(np.asarray(s[name], np.float32))
        out[opt] = adam_state_from_optax(
            getattr(trainer, opt), [name], s[opt],
            lambda x, name=name: {name: torch.tensor(np.asarray(x, np.float32))})
    return out


def jax_cql_full_state(trainer: CQLTrainer) -> Dict[str, Any]:
    """The port's trainer state as the JAX ``full_state`` layout with numpy
    leaves; each optimizer state is ``{"count", "mu", "nu"}``."""
    s = dict(jax_networks_state(trainer), n_train_steps=trainer._n_train_steps_total)
    s["policy_step"], s["critic_step"] = s["policy_opt"]["count"], s["critic_opt"]["count"]
    for name, opt in _TEMPERATURES:
        t = getattr(trainer, name)
        s[name] = t.detach().float().cpu().numpy()
        s[opt] = adam_state_to_numpy(getattr(trainer, opt), {name: t},
                                     lambda d, name=name: d[name].detach().float().cpu().numpy())
    return s
