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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict, state_dict_from_jax_dense_tree
from s2p_tpu_torch.rl.critics import CriticSLAC, q_subtree, soft_update
from s2p_tpu_torch.rl.scan_utils import make_flat_sampler, make_window_sampler


def _adam(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """``optax.adam``: β 0.9/0.999, ε 1e-8 outside the square root."""
    return torch.optim.Adam(module.parameters(), lr=lr, eps=1e-8)


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
                 device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.policy = policy.to(self.device)
        self.critic = critic.to(self.device)
        self.target_q = q_subtree(self.critic)
        self.policy_opt = _adam(self.policy, policy_lr)
        self.critic_opt = _adam(self.critic, qf_lr)
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
        return {k: v.detach() for k, v in metrics.items()}

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
        """``num_steps`` steps with batches drawn on the device. SLAC path:
        windows of ``buffer`` (the SLAC main buffer by default), half of
        each batch from ``buffer_gen`` when given, and the joint latent step
        on ``buffer`` after each RL step when the latent is unfrozen with
        period 1. State path: flat batches of a ``SimpleReplayBuffer``.
        Returns the last step's metrics; the host waits for none of them."""
        if self.slac_algo is None:
            if buffer is None or buffer_gen is not None:
                raise ValueError("the state path takes one SimpleReplayBuffer")
            sample = make_flat_sampler(buffer.device_state(), batch_size, self.generator)
            joint = False
        else:
            buffer = self.slac_algo.buffer if buffer is None else buffer
            sample = make_window_sampler(
                buffer.device_state(), batch_size, self.generator,
                buffer_gen.device_state() if buffer_gen is not None else None)
            joint = not self.freeze_slac and self.slac_update_period == 1
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(num_steps):
            metrics = self._step(sample())
            if joint:
                metrics.update(self.slac_algo.update_latent(buffer))
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
        snap = dict(policy_params=jax_dense_tree_from_state_dict(self.policy.state_dict()),
                    critic_params=jax_dense_tree_from_state_dict(self.critic.state_dict()),
                    target_q=jax_dense_tree_from_state_dict(self.target_q.state_dict())["params"])
        if self.slac_algo is not None:
            snap["latent_params"] = self.slac_algo.jax_params()
        return snap

    # -- crash-recovery state (optimizer state included) ----------------------
    def full_state(self) -> Dict[str, Any]:
        s = dict(policy_params=self.policy.state_dict(), policy_opt=self.policy_opt.state_dict(),
                 critic_params=self.critic.state_dict(), critic_opt=self.critic_opt.state_dict(),
                 target_q=self.target_q.state_dict(), rng=self.generator.get_state(),
                 n_train_steps=self._n_train_steps_total)
        if self.slac_algo is not None:
            s["slac_params"] = self.slac_algo.latent.state_dict()
            s["slac_opt"] = self.slac_algo.opt.state_dict()
        return s

    def load_full_state(self, s: Mapping[str, Any]) -> None:
        self.policy.load_state_dict(s["policy_params"])
        self.policy_opt.load_state_dict(s["policy_opt"])
        self.critic.load_state_dict(s["critic_params"])
        self.critic_opt.load_state_dict(s["critic_opt"])
        self.target_q.load_state_dict(s["target_q"])
        self.generator.set_state(s["rng"])
        self._n_train_steps_total = int(s["n_train_steps"])
        if self.slac_algo is not None and "slac_params" in s:
            self.slac_algo.latent.load_state_dict(s["slac_params"])
            self.slac_algo.opt.load_state_dict(s["slac_opt"])


# -- the JAX package's full_state ↔ the port's ---------------------------------

def _adam_state_from_optax(opt: torch.optim.Adam, module: torch.nn.Module, optax_state,
                           to_state_dict) -> Dict[str, Any]:
    """An optax ``adam`` state (``(ScaleByAdamState(count, mu, nu), …)`` or
    ``{"count", "mu", "nu"}``) as ``opt``'s state dict over ``module``."""
    adam = optax_state[0] if isinstance(optax_state, (tuple, list)) else optax_state
    get = (lambda k: adam[k]) if isinstance(adam, Mapping) else (lambda k: getattr(adam, k))  # noqa: E731
    mu, nu = to_state_dict(get("mu")), to_state_dict(get("nu"))
    count = float(np.asarray(get("count")))
    sd = opt.state_dict()
    sd["state"] = {i: dict(step=torch.tensor(count), exp_avg=mu[name], exp_avg_sq=nu[name])
                   for i, (name, _) in enumerate(module.named_parameters())}
    return sd


def _adam_state_to_numpy(opt: torch.optim.Adam, module: torch.nn.Module,
                         to_tree) -> Dict[str, Any]:
    """``opt``'s moments over ``module`` as ``{"count", "mu", "nu"}`` with
    numpy trees under flax names (``to_tree`` maps a state dict to one;
    optax's ``ScaleByAdamState`` is built from them)."""
    params = dict(module.named_parameters())
    state = opt.state_dict()["state"]
    moment = lambda k: to_tree({n: state[i][k] if state else torch.zeros_like(p)  # noqa: E731
                                for i, (n, p) in enumerate(params.items())})
    count = int(state[0]["step"]) if state else 0
    return dict(count=count, mu=moment("exp_avg"), nu=moment("exp_avg_sq"))


def iql_full_state_from_jax(trainer: IQLTrainer, s: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX ``IQLTrainer.full_state()`` (numpy leaves) as the port's
    ``full_state`` for ``trainer``; the generator state stays the
    trainer's (JAX keys do not map to it)."""
    from s2p_tpu_torch.slac.convert import state_dict_from_jax_latent_params

    out = dict(
        policy_params=state_dict_from_jax_dense_tree(s["policy_params"]),
        policy_opt=_adam_state_from_optax(trainer.policy_opt, trainer.policy, s["policy_opt"],
                                          state_dict_from_jax_dense_tree),
        critic_params=state_dict_from_jax_dense_tree(s["critic_params"]),
        critic_opt=_adam_state_from_optax(trainer.critic_opt, trainer.critic, s["critic_opt"],
                                          state_dict_from_jax_dense_tree),
        target_q=state_dict_from_jax_dense_tree(s["target_q"]),
        rng=trainer.generator.get_state(), n_train_steps=int(np.asarray(s["n_train_steps"])))
    if trainer.slac_algo is not None and "slac_params" in s:
        latent = trainer.slac_algo.latent
        out["slac_params"] = state_dict_from_jax_latent_params(s["slac_params"])
        out["slac_opt"] = _adam_state_from_optax(trainer.slac_algo.opt, latent, s["slac_opt"],
                                                 state_dict_from_jax_latent_params)
    return out


def jax_iql_full_state(trainer: IQLTrainer) -> Dict[str, Any]:
    """The port's trainer state as the JAX ``full_state`` layout with numpy
    leaves; each optimizer state is ``{"count", "mu", "nu"}``."""
    from s2p_tpu_torch.slac.convert import jax_latent_params_from_state_dict

    s = dict(policy_params=jax_dense_tree_from_state_dict(trainer.policy.state_dict()),
             policy_opt=_adam_state_to_numpy(trainer.policy_opt, trainer.policy,
                                             jax_dense_tree_from_state_dict),
             critic_params=jax_dense_tree_from_state_dict(trainer.critic.state_dict()),
             critic_opt=_adam_state_to_numpy(trainer.critic_opt, trainer.critic,
                                             jax_dense_tree_from_state_dict),
             target_q=jax_dense_tree_from_state_dict(trainer.target_q.state_dict())["params"],
             n_train_steps=trainer._n_train_steps_total)
    if trainer.slac_algo is not None:
        latent = trainer.slac_algo.latent
        s["slac_params"] = jax_latent_params_from_state_dict(latent.state_dict())
        s["slac_opt"] = _adam_state_to_numpy(trainer.slac_algo.opt, latent,
                                             jax_latent_params_from_state_dict)
    return s
