"""The RL trainers' optimizer and crash-recovery state.

The trainers' optimizers are ``optax.adam`` in the JAX package: β 0.9/0.999
and ε 1e-8 outside the square root, which is torch's Adam. Its state
crosses over as optax's ``ScaleByAdamState(count, mu, nu)`` (or a
``{"count", "mu", "nu"}`` dict) with ``mu`` and ``nu`` as trees under flax
names; a tree maps to a state dict keyed like ``named_parameters()``
through the caller's converter.

``networks_full_state`` and its inverse hold the part of ``full_state``
that IQL and CQL share: policy, critic, targets, their Adams, the step
count, the generator and, with SLAC, the latent model and its Adam.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Sequence

import numpy as np
import torch

from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict, state_dict_from_jax_dense_tree


def adam(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``."""
    return torch.optim.Adam(params, lr=lr, eps=1e-8)


def adam_state_from_optax(opt: torch.optim.Adam, names: Sequence[str], optax_state,
                          to_state_dict: Callable[[Any], Mapping[str, torch.Tensor]]
                          ) -> Dict[str, Any]:
    """An optax ``adam`` state (``(ScaleByAdamState(count, mu, nu), …)`` or
    ``{"count", "mu", "nu"}``) as ``opt``'s state dict; ``names`` are the
    parameters in ``opt``'s order, ``to_state_dict`` maps a moment tree to
    tensors under those names."""
    state = optax_state[0] if isinstance(optax_state, (tuple, list)) else optax_state
    get = ((lambda k: state[k]) if isinstance(state, Mapping)  # noqa: E731
           else (lambda k: getattr(state, k)))
    mu, nu = to_state_dict(get("mu")), to_state_dict(get("nu"))
    count = float(np.asarray(get("count")))
    sd = opt.state_dict()
    sd["state"] = {i: dict(step=torch.tensor(count), exp_avg=mu[n], exp_avg_sq=nu[n])
                   for i, n in enumerate(names)}
    return sd


def adam_state_to_numpy(opt: torch.optim.Adam, params: Mapping[str, torch.Tensor],
                        to_tree: Callable[[Mapping[str, torch.Tensor]], Any]) -> Dict[str, Any]:
    """``opt``'s moments over ``params`` (name → parameter, in ``opt``'s
    order) as ``{"count", "mu", "nu"}`` with numpy trees from ``to_tree``
    (optax's ``ScaleByAdamState`` is built from them). A parameter that has
    never had a gradient has no torch state: its moments are zero, as optax
    keeps them."""
    state = opt.state_dict()["state"]
    moment = lambda k: to_tree({n: state[i][k] if i in state else torch.zeros_like(p)  # noqa: E731
                                for i, (n, p) in enumerate(params.items())})
    count = int(next(iter(state.values()))["step"]) if state else 0
    return dict(count=count, mu=moment("exp_avg"), nu=moment("exp_avg_sq"))


def networks_full_state(trainer) -> Dict[str, Any]:
    """The port's ``full_state`` of a trainer with ``policy``, ``critic``,
    ``target_q``, their Adams, a ``generator`` and an optional
    ``slac_algo``."""
    s = dict(policy_params=trainer.policy.state_dict(),
             policy_opt=trainer.policy_opt.state_dict(),
             critic_params=trainer.critic.state_dict(),
             critic_opt=trainer.critic_opt.state_dict(),
             target_q=trainer.target_q.state_dict(), rng=trainer.generator.get_state(),
             n_train_steps=trainer._n_train_steps_total)
    if trainer.slac_algo is not None:
        s["slac_params"] = trainer.slac_algo.latent.state_dict()
        s["slac_opt"] = trainer.slac_algo.opt.state_dict()
    return s


def load_networks_full_state(trainer, s: Mapping[str, Any]) -> None:
    trainer.policy.load_state_dict(s["policy_params"])
    trainer.policy_opt.load_state_dict(s["policy_opt"])
    trainer.critic.load_state_dict(s["critic_params"])
    trainer.critic_opt.load_state_dict(s["critic_opt"])
    trainer.target_q.load_state_dict(s["target_q"])
    trainer.generator.set_state(s["rng"])
    trainer._n_train_steps_total = int(s["n_train_steps"])
    if trainer.slac_algo is not None and "slac_params" in s:
        trainer.slac_algo.latent.load_state_dict(s["slac_params"])
        trainer.slac_algo.opt.load_state_dict(s["slac_opt"])


def networks_state_from_jax(trainer, s: Mapping[str, Any]) -> Dict[str, Any]:
    """The policy, critic, target and (with SLAC) latent parts of a JAX
    trainer's ``full_state`` as the port's, optimizer states included; the
    part IQL, CQL and SAC share."""
    from s2p_tpu_torch.slac.convert import state_dict_from_jax_latent_params

    def opt_state(opt, module, tree, to_sd):
        return adam_state_from_optax(opt, [n for n, _ in module.named_parameters()], tree, to_sd)

    out = dict(
        policy_params=state_dict_from_jax_dense_tree(s["policy_params"]),
        policy_opt=opt_state(trainer.policy_opt, trainer.policy, s["policy_opt"],
                             state_dict_from_jax_dense_tree),
        critic_params=state_dict_from_jax_dense_tree(s["critic_params"]),
        critic_opt=opt_state(trainer.critic_opt, trainer.critic, s["critic_opt"],
                             state_dict_from_jax_dense_tree),
        target_q=state_dict_from_jax_dense_tree(s["target_q"]))
    if trainer.slac_algo is not None and "slac_params" in s:
        latent = trainer.slac_algo.latent
        out["slac_params"] = state_dict_from_jax_latent_params(s["slac_params"])
        out["slac_opt"] = opt_state(trainer.slac_algo.opt, latent, s["slac_opt"],
                                    state_dict_from_jax_latent_params)
    return out


def jax_networks_state(trainer) -> Dict[str, Any]:
    """The inverse of ``networks_state_from_jax``: numpy trees under flax
    names, each optimizer state as ``{"count", "mu", "nu"}``."""
    from s2p_tpu_torch.slac.convert import jax_latent_params_from_state_dict

    def opt_state(opt, module, to_tree):
        return adam_state_to_numpy(opt, dict(module.named_parameters()), to_tree)

    s = dict(policy_params=jax_dense_tree_from_state_dict(trainer.policy.state_dict()),
             policy_opt=opt_state(trainer.policy_opt, trainer.policy,
                                  jax_dense_tree_from_state_dict),
             critic_params=jax_dense_tree_from_state_dict(trainer.critic.state_dict()),
             critic_opt=opt_state(trainer.critic_opt, trainer.critic,
                                  jax_dense_tree_from_state_dict),
             target_q=jax_dense_tree_from_state_dict(trainer.target_q.state_dict())["params"])
    if trainer.slac_algo is not None:
        latent = trainer.slac_algo.latent
        s["slac_params"] = jax_latent_params_from_state_dict(latent.state_dict())
        s["slac_opt"] = opt_state(trainer.slac_algo.opt, latent, jax_latent_params_from_state_dict)
    return s
