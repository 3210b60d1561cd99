"""The port covers the JAX package: every module of ``s2p_tpu`` has a module
at the same path in ``s2p_tpu_torch`` (``gan/pallas_kernels.py``'s kernel
is ``gan/cuda_kernels.py``), and every name in a JAX subpackage's
``__all__`` is in the port's ``__all__`` (and importable), or in
``RENAMES`` with the reason it is spelled otherwise. The JAX side is read
with ``ast``, not imported."""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT, PORT_ROOT = os.path.join(REPO, "s2p_tpu"), os.path.join(REPO, "s2p_tpu_torch")

MODULE_RENAMES = {"gan/pallas_kernels.py": "gan/cuda_kernels.py"}  # the Pallas kernel's CUDA port
# JAX name -> (the port's name or None, why)
RENAMES = {
    ("nn", "fanin_uniform"): ("fanin_uniform_", "an in-place initializer of a torch parameter, "
                                                "where flax takes an init function"),
    ("nn", "scaled_orthogonal"): ("scaled_orthogonal_", "in place, as fanin_uniform_"),
    ("rl", "with_q_params"): (None, "a flax param-tree helper (the critic's q subtree swapped "
                                    "for a target's); the port's target networks are modules "
                                    "(q_subtree) evaluated directly"),
    ("world_model", "convert_ensemble_state_dict"): (
        "split_saved", "the port's EnsembleTransition loads the reference's torch state dict "
                       "as it is; split_saved separates its saved_* elite snapshot, the part "
                       "of the conversion that remains"),
}


def python_modules(root: str) -> set:
    return {os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
            for d, _, files in os.walk(root) for f in files if f.endswith(".py")}


def missing_modules(jax_root: str, port_root: str) -> list:
    port = python_modules(port_root)
    return sorted(m for m in python_modules(jax_root) if MODULE_RENAMES.get(m, m) not in port)


def ast_all(path: str) -> list:
    """``__all__`` of a module, from its ``__all__ = [...]`` and
    ``__all__ += [...]`` statements."""
    names = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            names += ast.literal_eval(node.value)
        elif isinstance(node, ast.AugAssign) and getattr(node.target, "id", None) == "__all__":
            names += ast.literal_eval(node.value)
    return names


SUBPACKAGES = sorted(d for d in os.listdir(JAX_ROOT)
                     if os.path.exists(os.path.join(JAX_ROOT, d, "__init__.py")))


def missing_exports(sub: str, port_all: list) -> list:
    out = []
    for name in ast_all(os.path.join(JAX_ROOT, sub, "__init__.py")):
        renamed = RENAMES.get((sub, name))
        if name in port_all or (renamed is not None and (renamed[0] is None
                                                         or renamed[0] in port_all)):
            continue
        out.append(name)
    return out


def test_every_jax_module_has_a_port():
    assert missing_modules(JAX_ROOT, PORT_ROOT) == []
    assert len(python_modules(JAX_ROOT)) >= 90


def test_a_missing_module_is_found(tmp_path):
    """The check fails when a module of the port is taken away."""
    for rel in python_modules(PORT_ROOT) - {"rl/encoders.py"}:
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()
    assert missing_modules(JAX_ROOT, str(tmp_path)) == ["rl/encoders.py"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_is_exported_by_the_port(sub):
    port = importlib.import_module(f"s2p_tpu_torch.{sub}")
    port_all = list(getattr(port, "__all__", []))
    assert missing_exports(sub, port_all) == []
    for name in port_all:
        assert hasattr(port, name), name
    for (s, name), (new, why) in RENAMES.items():
        if s == sub:
            assert why and name not in port_all and (new is None or new in port_all)


def test_a_missing_export_is_found():
    """The check fails when the port's ``__all__`` loses a JAX name."""
    port_all = list(importlib.import_module("s2p_tpu_torch.envs").__all__)
    assert missing_exports("envs", [n for n in port_all if n != "FrameStack"]) == ["FrameStack"]
    assert SUBPACKAGES == ["cli", "core", "data", "envs", "gan", "nn", "parallel", "rl",
                           "samplers", "slac", "testing", "utils", "world_model"]
