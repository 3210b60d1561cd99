"""SLAC latent-model weights between the port, the JAX package and the
reference's ``latent.pth``.

The port's module names are the reference checkpoint's, so a reference
state dict needs no renaming (``convert_latent_state_dict`` only drops the
parameter-free ``z1_prior_init`` and fills in the ``z2_posterior*``
aliases when a file lacks them). The JAX package's ``{"params": ...}`` tree
names layers flax-style:

- Gaussian heads: ``{head}/fc{i}/kernel`` (in, out) ↔ ``{head}.net.{2i}.weight``
  (out, in);
- encoder: ``encoder/conv{i}/kernel`` HWIO ↔ ``encoder.net.{2i}.weight`` OIHW;
- decoder: ``decoder/deconv{i}/kernel`` HWIO, un-flipped ↔
  ``decoder.net.{2i}.weight`` IOHW (``transpose(2, 3, 0, 1)`` both ways);
- the ``z2_posterior*`` aliases have no entry of their own there.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

GAUSSIAN_HEADS = ("z2_prior_init", "z1_prior", "z2_prior", "z1_posterior_init",
                  "z1_posterior", "reward")
ALIASES = {"z2_posterior_init": "z2_prior_init", "z2_posterior": "z2_prior"}
_FLAX_LAYER = {"encoder": "conv", "decoder": "deconv"}


def _np(v: Any) -> np.ndarray:
    return v.detach().float().cpu().numpy() if hasattr(v, "detach") else np.asarray(v, np.float32)


def _with_aliases(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    for alias, target in ALIASES.items():
        for k in [k for k in sd if k.startswith(target + ".")]:
            sd.setdefault(alias + k[len(target):], sd[k])
    return sd


def state_dict_from_jax_latent_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``LatentModel`` tree (``{"params": ...}`` or its inner dict,
    numpy leaves) as the port's state dict, aliases included."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for module, layers in params.items():
        for layer, leaves in layers.items():
            idx = 2 * int(re.sub(r"\D", "", layer))  # fc{i} / conv{i} / deconv{i}
            for leaf, v in leaves.items():
                arr = np.asarray(v, np.float32)
                if leaf == "kernel":
                    if module == "encoder":
                        arr = arr.transpose(3, 2, 0, 1)
                    elif module == "decoder":
                        arr = arr.transpose(2, 3, 0, 1)
                    else:
                        arr = arr.T
                key = f"{module}.net.{idx}.{'weight' if leaf == 'kernel' else leaf}"
                sd[key] = torch.tensor(np.ascontiguousarray(arr))
    return _with_aliases(sd)


def jax_latent_params_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse: the port's (or a reference) state dict as the JAX
    package's ``{"params": ...}`` tree of float32 numpy leaves."""
    params: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for key, v in sd.items():
        module, _, seq_idx, leaf = key.split(".")
        if module in ALIASES or module == "z1_prior_init":
            continue
        arr = _np(v)
        if leaf == "weight":
            if module == "encoder":
                arr = arr.transpose(2, 3, 1, 0)
            elif module == "decoder":
                arr = arr.transpose(2, 3, 0, 1)
            elif module in GAUSSIAN_HEADS:
                arr = arr.T
            else:
                raise KeyError(f"unexpected latent key {key!r}")
        layer = f"{_FLAX_LAYER.get(module, 'fc')}{int(seq_idx) // 2}"
        params.setdefault(module, {}).setdefault(layer, {})[
            "kernel" if leaf == "weight" else leaf] = np.ascontiguousarray(arr, np.float32)
    return {"params": params}


def convert_latent_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference ``latent.pth`` state dict as the port's: float32 CPU
    tensors under the same names, without ``z1_prior_init.*``, with the
    ``z2_posterior*`` aliases."""
    sd = {k: torch.as_tensor(_np(v)) for k, v in state_dict.items()
          if not k.startswith("z1_prior_init.")}
    return _with_aliases(sd)
