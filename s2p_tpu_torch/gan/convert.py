"""Generator weights between the port and JAX params or torch ``.pth`` files.

The port of the parts of ``s2p_tpu/gan/convert.py`` that load and save a
generator. The port's module names equal the flax parameter tree joined
with '.', so a JAX ``params`` tree maps to a state dict leaf by leaf, and
back:

- ``kernel`` rank 4 (conv):  flax HWIO → torch OIHW
- ``kernel`` rank 2 (dense): flax (in, out) → torch (out, in)
- ``bias``:                  copied

``.pth`` files from the SPADE lineage (the released S2P checkpoints) use
other module names; ``spade_block_name_map`` and ``remap_state_dict`` turn
them into ours, and ``diff_state_dict`` reports what does not line up.
A checkpoint of SPADE's own generator (``netG=spade``, whose module names
the port's ``SPADEGenerator`` keeps) loads through
``state_dict_from_spade``, which folds its spectral norm.
"""

from __future__ import annotations

import difflib
import pickle
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

_LEAF_TO_TORCH = {"kernel": "weight", "bias": "bias", "scale": "weight"}


def flax_to_torch_leaf(name: str, value: Any) -> np.ndarray:
    v = np.asarray(value)
    if name == "kernel":
        if v.ndim == 4:
            return v.transpose(3, 2, 0, 1)
        if v.ndim == 2:
            return v.T
    return v


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX generator's ``params`` tree (numpy leaves) as the port's
    state dict of float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def rec(node: Mapping[str, Any], path: str) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                rec(v, f"{path}.{k}" if path else k)
            else:
                leaf = flax_to_torch_leaf(k, v).astype(np.float32)
                out[f"{path}.{_LEAF_TO_TORCH.get(k, k)}"] = torch.from_numpy(leaf.copy())

    rec(params, "")
    return out


def jax_params_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_jax_params``: a state dict as the
    flax ``params`` tree with float32 numpy leaves (HWIO conv kernels,
    (in, out) dense kernels)."""
    tree: Dict[str, Any] = {}
    for key, value in sd.items():
        *path, leaf = key.split(".")
        v = _to_numpy(value).astype(np.float32)
        if leaf == "weight":
            if v.ndim == 4:
                leaf, v = "kernel", v.transpose(2, 3, 1, 0)
            elif v.ndim == 2:
                leaf, v = "kernel", v.T
            else:
                leaf = "scale"
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(v)
    return tree


def save_generator_checkpoint(path_base: str, generator: torch.nn.Module) -> None:
    """Write ``{path_base}.pkl`` (``{"params": <flax-layout numpy tree>}``,
    as the JAX train CLI writes it) and ``{path_base}.pth`` (the state dict:
    float32 CPU tensors under the flax tree's names, the layout of JAX's
    ``params_to_state_dict``), so the JAX package loads what the port
    trains."""
    sd = {k: v.detach().float().cpu().contiguous() for k, v in generator.state_dict().items()}
    with open(path_base + ".pkl", "wb") as f:
        pickle.dump({"params": jax_params_from_state_dict(sd)}, f)
    torch.save(sd, path_base + ".pth")


# -- SPADE-convention name mapping -------------------------------------------
#
# SPADE's generator walks fc → head_0 → G_middle_0 → G_middle_1 → up_0..up_k
# → conv_img and wraps its norm's first conv in a Sequential
# (``mlp_shared.0.weight``); ours walks seed_fc → block_0..block_n → conv_img.

SPADE_SUBSTITUTIONS: List[Tuple[str, str]] = [
    (".mlp_shared.0.", ".mlp_shared."),
]


def state_dict_from_spade(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A state dict in SPADE's own names (NVlabs/SPADE's ``netG``) as the
    port's ``SPADEGenerator`` takes it: each spectral-normed conv's
    ``weight_orig``, ``weight_u`` and ``weight_v`` folded into ``weight`` as
    an eval-mode ``torch.nn.utils.spectral_norm`` computes it, ``W / (uᵀ W
    v)`` with W flattened to [out, rest]; ``mlp_shared.0.*`` as
    ``mlp_shared.*``; each batch norm's ``num_batches_tracked`` (a training
    counter) dropped. ``param_free_norm.running_mean``/``running_var`` and
    every other key pass as they are, as float32 tensors (on their device;
    numpy arrays on the CPU). A ``weight_orig`` without both vectors stays
    as it is, for ``diff_state_dict`` to report."""
    t = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
         for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    for key, value in t.items():
        if key.endswith((".weight_u", ".weight_v", ".num_batches_tracked")):
            continue
        value, base = value.float(), key[: -len("_orig")]
        if key.endswith(".weight_orig") and base + "_u" in t and base + "_v" in t:
            u, v = t[base + "_u"].float(), t[base + "_v"].float()
            value, key = value / torch.dot(u, torch.mv(value.flatten(1), v)), base
        out[key.replace(".mlp_shared.0.", ".mlp_shared.")] = value
    return out


def spade_block_name_map(n_blocks: int) -> Dict[str, str]:
    """Map SPADE's block sequence onto ``block_0..block_{n-1}`` in order."""
    spade_blocks = ["head_0", "G_middle_0", "G_middle_1"] + [
        f"up_{k}" for k in range(max(0, n_blocks - 3))
    ]
    m = {"fc": "seed_fc", "conv_img": "conv_img"}
    for i, name in enumerate(spade_blocks[:n_blocks]):
        m[name] = f"block_{i}"
    return m


def remap_state_dict(
    sd: Mapping[str, Any],
    name_map: Mapping[str, str],
    substitutions: Sequence[Tuple[str, str]] = tuple(SPADE_SUBSTITUTIONS),
) -> Dict[str, Any]:
    """Rename keys: longest-prefix module rename via ``name_map`` (a value
    of "" drops the key, e.g. buffers), then substring ``substitutions``.
    Module prefixes match at '.' boundaries only."""
    rules = sorted(name_map.items(), key=lambda kv: -len(kv[0]))
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        nk = k
        for src, dst in rules:
            if nk == src or nk.startswith(src + "."):
                nk = None if dst == "" else dst + nk[len(src):]
                break
        if nk is None:
            continue
        for old, new in substitutions:
            nk = nk.replace(old, new)
        out[nk] = v
    return out


def diff_state_dict(sd: Mapping[str, Any], template: Mapping[str, Any]) -> Dict[str, Any]:
    """How a state dict lines up with a model's own (``template``, e.g.
    ``gen.state_dict()``): missing and unexpected keys, shape mismatches,
    and name-similarity suggestions for the missing keys."""
    expected = {k: tuple(np.shape(_to_numpy(v))) for k, v in template.items()}
    sd_shapes = {k: tuple(np.shape(_to_numpy(v))) for k, v in sd.items()}
    missing = sorted(k for k in expected if k not in sd_shapes)
    unexpected = sorted(k for k in sd_shapes if k not in expected)
    mismatched = sorted(
        (k, sd_shapes[k], expected[k])
        for k in expected if k in sd_shapes and sd_shapes[k] != expected[k])
    suggestions = {
        k: difflib.get_close_matches(k, unexpected, n=3, cutoff=0.5) for k in missing}
    return dict(
        missing=missing,
        unexpected=unexpected,
        shape_mismatch=mismatched,
        suggestions={k: v for k, v in suggestions.items() if v},
        ok=not missing and not mismatched,
    )


def format_diff(report: Mapping[str, Any], max_lines: int = 40) -> str:
    lines: List[str] = []
    if report["ok"]:
        lines.append("state_dict matches the model template")
        if report["unexpected"]:
            lines.append(f"  ({len(report['unexpected'])} unused checkpoint keys)")
        return "\n".join(lines)
    for k in report["missing"][:max_lines]:
        hint = report["suggestions"].get(k)
        lines.append(f"  missing  {k}" + (f"   (closest: {', '.join(hint)})" if hint else ""))
    for k, got, want in report["shape_mismatch"][:max_lines]:
        lines.append(f"  shape    {k}: checkpoint {got} vs model {want}")
    for k in report["unexpected"][:max_lines]:
        lines.append(f"  unused   {k}")
    n_more = (len(report["missing"]) + len(report["shape_mismatch"])
              + len(report["unexpected"]) - 3 * max_lines)
    if n_more > 0:
        lines.append(f"  ... and more ({n_more} lines truncated)")
    return "\n".join(lines)


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """A torch ``.pth`` file as a flat numpy state dict; checkpoints nested
    under 'netG' / 'generator' / 'G' / 'model' / 'state_dict' unwrap."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and obj and not any(
        hasattr(v, "numpy") or isinstance(v, np.ndarray) for v in obj.values()
    ):
        for key in ("netG", "generator", "G", "model", "state_dict"):
            if key in obj:
                obj = obj[key]
                break
    return {k: _to_numpy(v) for k, v in obj.items()}


def load_generator_checkpoint(path: str, generator: torch.nn.Module,
                              name_map: Mapping[str, str] | None = None) -> torch.nn.Module:
    """Load a checkpoint into ``generator`` (strict) and return it.

    ``.pkl``: the pickled JAX params the train CLI writes (numpy leaves,
    ``{'params': ...}``). ``.pth``: a torch state dict; keys are tried as
    they are, then in SPADE's own layout (``state_dict_from_spade``: a
    ``netG=spade`` checkpoint), then through the SPADE name map; an
    explicit ``name_map`` replaces all three. On failure the error carries
    the ``diff_state_dict`` report of every attempt."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            obj = pickle.load(f)
        sd = state_dict_from_jax_params(obj["params"] if "params" in obj else obj)
        generator.load_state_dict(sd, strict=True)
        return generator

    template = generator.state_dict()
    sd = load_pth(path)
    if name_map is not None:
        candidates = [("explicit name_map", remap_state_dict(sd, name_map))]
    else:
        n_blocks = sum(1 for k in template if k.endswith(".conv_0.weight"))
        candidates = [
            ("as-is", dict(sd)),
            ("SPADE layout", state_dict_from_spade(sd)),
            ("SPADE name map", remap_state_dict(sd, spade_block_name_map(n_blocks))),
        ]
    reports = []
    for label, cand in candidates:
        report = diff_state_dict(cand, template)
        if report["ok"]:
            generator.load_state_dict(
                {k: torch.as_tensor(np.asarray(cand[k], np.float32)) for k in template},
                strict=True)
            return generator
        reports.append((label, report))
    raise ValueError(
        f"checkpoint {path!r} does not match the generator.\n"
        + "\n".join(f"--- tried {label}:\n{format_diff(r)}" for label, r in reports))


def _to_numpy(v: Any) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)
