"""Gaussian ensemble dynamics model.

The port of ``s2p_tpu/world_model/ensemble.py``: E Swish MLPs over
``[obs ‖ act]``, each predicting a diagonal Normal over ``[next_obs ‖
reward]``, with

- per-member linear layers (``EnsembleLinear``: one batched product over an
  (E, in, out) weight; the JAX package leaves this product to XLA, so it is
  a ``torch.baddbmm`` here, not a hand kernel),
- a residual ("local") mean on the observation part,
- learned, soft-clamped logstd bounds (``soft_clamp``, bounds init +1/−5),
- elite bookkeeping (``save_members``/``restore_members``) over state dicts.

Module names are the reference checkpoint's (``backbones.{i}``,
``output_layer``, ``max_logstd``, ``min_logstd``), so its state dict loads
directly once the ``saved_*`` entries (its elite snapshot) are split off
(``split_saved``). ``state_dict_from_jax_ensemble_params`` and
``jax_ensemble_params_from_state_dict`` carry weights between the port and
the JAX package's ``{"params": ...}`` tree.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def soft_clamp(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Clamp ``x`` into (lo, hi) softly, keeping a gradient everywhere."""
    x = hi - F.softplus(hi - x)
    return lo + F.softplus(x - lo)


class EnsembleLinear(nn.Module):
    """All members' linear layer: x ``[B, in]`` (shared by every member) or
    ``[E, B, in]`` → ``[E, B, out]``. Weight (E, in, out), bias (E, 1, out)."""

    def __init__(self, in_features: int, out_features: int, ensemble_size: int = 7):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(ensemble_size, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(ensemble_size, 1, out_features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Truncated normal weight (std 1/(2√in), cut at ±2σ) from ``gen``;
        zero bias."""
        std = 1.0 / (2.0 * math.sqrt(self.in_features))
        with torch.no_grad():
            self.weight.copy_(nn.init.trunc_normal_(
                torch.empty(self.weight.shape), std=std, a=-2 * std, b=2 * std, generator=gen))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.expand(self.weight.shape[0], *x.shape)
        return torch.baddbmm(self.bias, x, self.weight)


class EnsembleTransition(nn.Module):
    """obs_action ``[B, obs+act]`` or ``[E, B, obs+act]`` → (mean, std),
    each ``[E, B, obs (+1 with reward)]``.

    Built on ``device`` (the card unless the caller asks otherwise) with
    weights drawn from ``torch.Generator().manual_seed(seed)`` on the CPU,
    so a seed gives the same weights on every device."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_features: int = 256,
                 hidden_layers: int = 3, ensemble_size: int = 7, mode: str = "local",
                 with_reward: bool = True, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if mode not in ("local", "global"):
            raise ValueError(f"unknown mode {mode!r}")
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.ensemble_size, self.mode, self.with_reward = ensemble_size, mode, with_reward
        out_dim = obs_dim + int(with_reward)
        widths = [obs_dim + action_dim] + [hidden_features] * hidden_layers
        self.backbones = nn.ModuleList(
            EnsembleLinear(i, o, ensemble_size) for i, o in zip(widths[:-1], widths[1:]))
        self.output_layer = EnsembleLinear(hidden_features, 2 * out_dim, ensemble_size)
        self.max_logstd = nn.Parameter(torch.ones(out_dim))
        self.min_logstd = nn.Parameter(-5.0 * torch.ones(out_dim))
        gen = torch.Generator().manual_seed(seed)
        for layer in [*self.backbones, self.output_layer]:
            layer.reset_parameters(gen)
        self.to(device)

    def forward(self, obs_action: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = obs_action
        for layer in self.backbones:
            h = F.silu(layer(h))  # Swish
        mu, logstd = self.output_layer(h).chunk(2, dim=-1)
        logstd = soft_clamp(logstd, self.min_logstd, self.max_logstd)
        if self.mode == "local":  # the mean of the observation part is a residual
            prev_obs = obs_action[..., :self.obs_dim]
            if self.with_reward:
                mu = torch.cat([mu[..., :self.obs_dim] + prev_obs, mu[..., self.obs_dim:]], -1)
            else:
                mu = mu + prev_obs
        return mu, torch.exp(logstd)


# -- elite bookkeeping --------------------------------------------------------

def _is_member_leaf(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("weight", "bias")


def save_members(saved: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
                 indexes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """A copy of the state dict ``saved`` whose member rows ``indexes`` of
    every weight and bias come from ``params``; the shared logstd bounds
    stay ``saved``'s."""
    out = {}
    for k, s in saved.items():
        if _is_member_leaf(k):
            idx = torch.as_tensor(list(indexes), dtype=torch.long, device=s.device)
            s = s.clone()
            s[idx] = params[k][idx].to(s.device)
        out[k] = s
    return out


def restore_members(params: Mapping[str, torch.Tensor], saved: Mapping[str, torch.Tensor],
                    indexes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """A copy of ``params`` with member rows ``indexes`` taken back from
    ``saved``."""
    return save_members(params, saved, indexes)


# -- training ---------------------------------------------------------------

def ensemble_nll_loss(model: EnsembleTransition, obs_action: torch.Tensor,
                      target: torch.Tensor, bound_penalty: float = 0.01) -> torch.Tensor:
    """Gaussian NLL (without its constant) averaged over members, rows and
    outputs, plus ``bound_penalty`` × (Σ max_logstd − Σ min_logstd). Inputs
    are shared ``[B, ·]`` or per member (bootstrapped) ``[E, B, ·]``."""
    mu, std = model(obs_action)
    var = std ** 2
    nll = torch.mean((mu - target) ** 2 / var + torch.log(var))
    return nll + bound_penalty * (model.max_logstd.sum() - model.min_logstd.sum())


def make_ensemble_train_step(model: EnsembleTransition, lr: float = 1e-3
                             ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``step(obs_action, target) → loss``: one Adam NLL update of every
    member at once. ``torch.optim.Adam`` with its defaults is ``optax.adam``
    (β 0.9/0.999, ε 1e-8 outside the square root). The loss is returned on
    the device, so a loop of steps does not wait for the card."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def step(obs_action: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = ensemble_nll_loss(model, obs_action, target)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


# -- weights between the port, the JAX package and the reference -------------

def split_saved(state_dict: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the model's entries, the ``saved_*`` elite snapshot under the
    names of the weights it copies) of a reference-format state dict."""
    params, saved = {}, {}
    for k, v in state_dict.items():
        *path, leaf = k.split(".")
        if leaf.startswith("saved_"):
            saved[".".join(path + [leaf[len("saved_"):]])] = v
        else:
            params[k] = v
    return params, saved


def state_dict_from_jax_ensemble_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``EnsembleTransition`` parameter tree with numpy leaves
    (``{"params": ...}`` or its inner dict) as the port's state dict of
    float32 CPU tensors. The layouts agree; only the names map
    (``backbones_{i}/weight`` → ``backbones.{i}.weight``)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for mod, node in params.items():
        name = mod.replace("backbones_", "backbones.")
        if isinstance(node, Mapping):
            for leaf, v in node.items():
                out[f"{name}.{leaf}"] = torch.from_numpy(np.array(v, np.float32))
        else:
            out[name] = torch.from_numpy(np.array(node, np.float32))
    return out


def jax_ensemble_params_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse: the port's state dict as the JAX package's
    ``{"params": ...}`` tree of float32 numpy leaves."""
    tree: Dict[str, Any] = {}
    for k, v in sd.items():
        arr = np.ascontiguousarray(
            v.detach().float().cpu().numpy() if hasattr(v, "detach") else np.asarray(v, np.float32))
        parts = k.split(".")
        if len(parts) == 1:
            tree[k] = arr
        else:
            mod = "_".join(parts[:-1])  # backbones.0 → backbones_0
            tree.setdefault(mod, {})[parts[-1]] = arr
    return {"params": tree}
