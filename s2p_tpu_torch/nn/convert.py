"""flax parameter trees (numpy leaves) ↔ torch state dicts for the nn
library's modules and the RL networks built from them.

flax ``Dense`` kernels are ``(in, out)`` where torch's ``Linear`` weight is
``(out, in)``; conv kernels ``(kh, kw, in, out)`` where torch's are
``(out, in, kh, kw)``; ``ConvTranspose2dTorch`` kernels (modules named
``deconv*``) ``(kh, kw, in, out)``, un-flipped, where torch's are ``(in,
out, kh, kw)``; the ``scale`` of a LayerNorm or GroupNorm (modules named
``layer_norm*`` or ``norm*``) is torch's ``weight``. Module paths map one
to one (``qf1/fc0`` ↔ ``qf1.fc0``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _kernel_to_torch(module: str, k: np.ndarray) -> np.ndarray:
    if k.ndim == 2:
        return k.T
    return k.transpose(2, 3, 0, 1) if module.startswith("deconv") else k.transpose(3, 2, 0, 1)


def _kernel_to_flax(module: str, w: np.ndarray) -> np.ndarray:
    if w.ndim == 2:
        return w.T
    return w.transpose(2, 3, 0, 1) if module.startswith("deconv") else w.transpose(2, 3, 1, 0)


def state_dict_from_jax_dense_tree(tree: Mapping, prefix: str = "") -> dict:
    """A flax ``{"params": ...}`` tree, or its inner dict, as a torch state
    dict of float32 CPU tensors."""
    tree = tree.get("params", tree) if not prefix else tree
    out = {}
    for name, node in tree.items():
        if isinstance(node, Mapping):
            out.update(state_dict_from_jax_dense_tree(node, f"{prefix}{name}."))
            continue
        arr = np.asarray(node, np.float32)
        module = prefix.rstrip(".").rsplit(".", 1)[-1]
        if name == "kernel":
            name, arr = "weight", _kernel_to_torch(module, arr)
        elif name == "scale":
            name = "weight"
        out[f"{prefix}{name}"] = torch.tensor(np.ascontiguousarray(arr))
    return out


def jax_dense_tree_from_state_dict(sd: Mapping) -> dict:
    """The inverse: a torch state dict as the ``{"params": ...}`` tree of
    float32 numpy leaves."""
    tree: dict = {}
    for k, v in sd.items():
        arr = v.detach().float().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        *path, leaf = k.split(".")
        module = path[-1] if path else ""
        if leaf == "weight" and module.startswith(("layer_norm", "norm")):
            leaf = "scale"
        elif leaf == "weight":
            leaf, arr = "kernel", _kernel_to_flax(module, arr)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr, np.float32)
    return {"params": tree}
