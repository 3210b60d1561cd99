"""One rank of the data-parallel RL tests (``tests/test_torch_rl_dp.py``).

``spawn_ranks(run, world, (spec_file, out_dir))`` runs every case of the
spec on each rank of a gloo group on the CPU, and each rank saves what it
saw to ``{out_dir}/rank{r}.pt``: per case, its results, or the traceback of
the error that stopped it (a failing case does not stop the others).

The spec (``torch.save``d) holds the SLAC algorithm's arguments (``slac``),
its starting latent weights (``latent``) and the real dataset its buffer
ingests (``dataset``), the networks' widths (``hidden``), and ``cases``,
each a dict with ``name``, ``kind``, ``mode``, optional overrides of the
SLAC arguments (``slac``), the trainer's arguments
(``trainer``: ``algo`` "iql" or "cql", the policy's input ``policy_input``
"feature_action", "latent_z" or "state", ``obs_dim``, the starting
``policy`` and ``critic`` state dicts and the trainer's keyword
arguments ``kw``) and ``inputs``, one per rank:

- kind ``train``: ``train(batch, ...)`` with the given posterior noise,
  policy draws and latent draws (``inputs[r]``: ``batch``, ``draws``,
  ``latent_draws``);
- kind ``elbo``: ``SlacAlgorithm.update_latent(idx=, noise=)``;
- kind ``many``: ``train_many_dp`` over a ``SimpleReplayBuffer`` of the
  given ``rows`` for ``num_steps`` steps at global batch ``batch_size``
  with this rank's ``indices`` and ``draws``.

Modes: ``dp`` (the trainer and the SLAC algorithm in the mesh's data
group, ``inputs[rank]``); ``no_sync`` (no group, each rank steps on its
own ``inputs[rank]``); ``world1`` (``inputs[0]``, the global batch, twice:
with a group of this rank alone and with none).

Each result holds the metrics and the state after the step in JAX's
layouts (numpy trees: the trainer's ``full_state``, whose Adam first
moments carry the gradients, or the latent model's parameters and Adam
moments).
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from s2p_tpu_torch.data.replay import SimpleReplayBuffer
from s2p_tpu_torch.parallel import MeshSpec, make_mesh
from s2p_tpu_torch.parallel.distributed import initialize_distributed
from s2p_tpu_torch.rl import (CQLTrainer, CriticSLAC, IQLTrainer, TanhGaussianPolicy,
                              jax_cql_full_state, jax_iql_full_state, train_many_dp)
from s2p_tpu_torch.rl.state import adam_state_to_numpy
from s2p_tpu_torch.slac import SlacAlgorithm
from s2p_tpu_torch.slac.convert import jax_latent_params_from_state_dict


ROW_KEYS = ("observations", "actions", "rewards", "terminals", "next_observations")


def state_buffer(rows: Dict[str, Any], device) -> SimpleReplayBuffer:
    """A ``SimpleReplayBuffer`` on ``device`` holding ``rows`` (arrays keyed
    as ``ROW_KEYS``), added one transition at a time."""
    buf = SimpleReplayBuffer(len(rows["rewards"]), rows["observations"].shape[1],
                             rows["actions"].shape[1], device=device)
    for o, a, r, t, no in zip(*(rows[k] for k in ROW_KEYS)):
        buf.add_sample(o, a, r, t, no)
    return buf


def make_slac(spec: Dict[str, Any], case: Dict[str, Any], group) -> SlacAlgorithm:
    slac = SlacAlgorithm(device="cpu", dp_group=group, **dict(spec["slac"],
                                                                **case.get("slac", {})))
    slac.latent.load_state_dict(spec["latent"], strict=True)
    slac.buffer.ingest_real(spec["dataset"])
    return slac


def make_trainer(spec: Dict[str, Any], case: Dict[str, Any], group):
    t = case["trainer"]
    slac = make_slac(spec, case, group) if t["policy_input"] != "state" else None
    if slac is None:
        obs_dim = pin = t["obs_dim"]
    else:
        obs_dim = slac.z_dim
        pin = slac.feature_action_dim if t["policy_input"] == "feature_action" else obs_dim
    act = spec["slac"]["action_dim"]
    policy = TanhGaussianPolicy(pin, spec["hidden"], act)
    policy.load_state_dict(t["policy"], strict=True)
    critic = CriticSLAC(obs_dim, act, spec["hidden"])
    critic.load_state_dict(t["critic"], strict=True)
    cls = IQLTrainer if t["algo"] == "iql" else CQLTrainer
    kw = dict(t["kw"])
    if slac is not None:
        kw.update(slac_algo=slac, slac_policy_input_type=t["policy_input"])
    return cls(policy, critic, device="cpu", dp_group=group, **kw)


def report(trainer, slac: Optional[SlacAlgorithm], metrics) -> Dict[str, Any]:
    """The metrics and the state after the step in JAX's layouts: the
    trainer's ``full_state`` (with the latent's, when it has SLAC), or the
    latent model's parameters and Adam moments."""
    out: Dict[str, Any] = dict(metrics={k: v.item() for k, v in metrics.items()})
    if trainer is not None:
        full = jax_iql_full_state if isinstance(trainer, IQLTrainer) else jax_cql_full_state
        out["state"] = full(trainer)
    else:
        named = dict(slac.latent.named_parameters())
        out["state"] = dict(
            slac_params=jax_latent_params_from_state_dict(slac.latent.state_dict()),
            slac_opt=adam_state_to_numpy(slac.opt, named, jax_latent_params_from_state_dict))
    return out


def run_inputs(spec, case, group, inputs, mesh=None) -> Dict[str, Any]:
    kind = case["kind"]
    if kind == "elbo":
        slac = make_slac(spec, case, group)
        losses = slac.update_latent(idx=inputs["idx"], noise=inputs["noise"])
        return report(None, slac, losses)
    trainer = make_trainer(spec, case, group)
    if kind == "train":
        if isinstance(trainer, IQLTrainer):
            metrics = trainer.train(inputs["batch"], prepare_noise=inputs["draws"],
                                    latent_draws=inputs.get("latent_draws"))
        else:
            metrics = trainer.train(inputs["batch"], draws=inputs["draws"],
                                    latent_draws=inputs.get("latent_draws"))
    else:  # many
        metrics = train_many_dp(trainer, mesh, case["num_steps"], case["batch_size"],
                                buffer=state_buffer(case["rows"], "cpu"),
                                indices=inputs["indices"], draws=inputs["draws"])
    return report(trainer, None, metrics)


def run_case(mesh, spec, case) -> Dict[str, Any]:
    rank = dist.get_rank()
    if case["mode"] == "dp":
        return run_inputs(spec, case, mesh.groups["data"], case["inputs"][rank], mesh)
    if case["mode"] == "no_sync":
        return run_inputs(spec, case, None, case["inputs"][rank])
    # world1: every rank creates every group, in the same order
    alone = [dist.new_group([r]) for r in range(dist.get_world_size())][rank]
    return {name: run_inputs(spec, case, group, case["inputs"][0])
            for name, group in (("group", alone), ("none", None))}


def run(rank: int, world: int, init_method: str, spec_file: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = make_mesh(MeshSpec(data=world))
    spec = torch.load(spec_file, weights_only=False)
    results: Dict[str, Any] = {}
    for case in spec["cases"]:
        try:
            results[case["name"]] = run_case(mesh, spec, case)
        except Exception:  # reported to the test of this case, which fails on it
            results[case["name"]] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()

