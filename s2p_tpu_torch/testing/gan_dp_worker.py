"""One rank of the data-parallel GAN tests (``tests/test_torch_gan_dp.py``).

``spawn_ranks(run, world, (spec_file, out_dir))`` runs every case of the
spec on each rank of a gloo group on the CPU, and each rank saves what it
saw to ``{out_dir}/rank{r}.pt``: per case, its results, or the traceback of
the error that stopped it (a failing case does not stop the others).

The spec (``torch.save``d) holds the trainer's arguments (``state_dim``,
``image_size``, ``generator_kwargs``, ``discriminator_kwargs``) and its
starting weights (``g``, ``d``, ``vgg``: state dicts, ``vgg`` None for no
perceptual loss), and ``cases``, each a dict with ``name`` and ``kind``:

- ``steps``: ``train_step`` on this rank's ``shard_batch`` of each global
  batch in ``batches``, with the loss config ``loss`` and ``d_every``; with
  ``sync`` False the trainer has no group (each rank steps on its own half);
- ``many_dp``: ``train_many_dp`` over ``data`` (host arrays) for
  ``num_steps`` steps at global batch ``batch_size`` with this rank's
  ``indices[rank]``;
- ``world1``: ``train_step`` on the whole of each batch of ``batches``
  twice, once with a group of this rank alone and once with none.

Each case may also set ``opt`` (``GANOptConfig``'s fields).

Each result holds, per step, the metrics, the gradients and the weights
after the step.
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from s2p_tpu_torch.gan.discriminator import MultiscaleDiscriminator
from s2p_tpu_torch.gan.generator import S2PGenerator
from s2p_tpu_torch.gan.losses import GANLossConfig
from s2p_tpu_torch.gan.perceptual import PerceptualLoss
from s2p_tpu_torch.gan.training import GANOptConfig, GANTrainer
from s2p_tpu_torch.parallel import MeshSpec, make_mesh, shard_batch
from s2p_tpu_torch.parallel.distributed import initialize_distributed


def make_trainer(spec: Dict[str, Any], case: Dict[str, Any], group) -> GANTrainer:
    gen = S2PGenerator(spec["state_dim"], image_size=spec["image_size"], device="cpu",
                       **spec["generator_kwargs"])
    gen.load_state_dict(spec["g"], strict=True)
    disc = MultiscaleDiscriminator(spec["state_dim"], device="cpu",
                                   **spec["discriminator_kwargs"])
    disc.load_state_dict(spec["d"], strict=True)
    perceptual = (PerceptualLoss(spec["vgg"], device="cpu")
                  if spec["vgg"] is not None else None)
    return GANTrainer(gen, disc, perceptual, GANLossConfig(**case.get("loss", {})),
                      GANOptConfig(**case.get("opt", {})), d_every=case.get("d_every", 1),
                      dp_group=group)


def snapshot(trainer: GANTrainer, metrics) -> Dict[str, Any]:
    return dict(
        metrics={k: v.item() for k, v in metrics.items()},
        grads={mod: {k: p.grad.clone() for k, p in getattr(trainer, mod).named_parameters()}
               for mod in ("generator", "discriminator")},
        weights={mod: {k: v.clone() for k, v in getattr(trainer, mod).state_dict().items()}
                 for mod in ("generator", "discriminator")})


def run_steps(mesh, spec, case) -> Dict[str, Any]:
    trainer = make_trainer(spec, case, mesh.groups["data"] if case.get("sync", True) else None)
    return dict(steps=[snapshot(trainer, trainer.train_step(shard_batch(mesh, b)))
                       for b in case["batches"]])


def run_many_dp(mesh, spec, case) -> Dict[str, Any]:
    trainer = make_trainer(spec, case, mesh.groups["data"])
    metrics = trainer.train_many_dp(mesh, case["data"], case["num_steps"], case["batch_size"],
                                    indices=np.asarray(case["indices"][mesh.coords["data"]]))
    out = snapshot(trainer, metrics)
    out["shard"] = {k: v.clone() for k, v in trainer._dp_data[1].items()}
    return out


def run_world1(mesh, spec, case) -> Dict[str, Any]:
    # every rank creates every group, in the same order
    alone = [dist.new_group([r]) for r in range(dist.get_world_size())][dist.get_rank()]
    out = {}
    for name, group in (("group", alone), ("none", None)):
        trainer = make_trainer(spec, case, group)
        out[name] = [snapshot(trainer, trainer.train_step(b)) for b in case["batches"]]
    return out


CASES = dict(steps=run_steps, many_dp=run_many_dp, world1=run_world1)


def run(rank: int, world: int, init_method: str, spec_file: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = make_mesh(MeshSpec(data=world))
    spec = torch.load(spec_file, weights_only=False)
    results: Dict[str, Any] = {}
    for case in spec["cases"]:
        try:
            results[case["name"]] = CASES[case["kind"]](mesh, spec, case)
        except Exception:  # reported to the test of this case, which fails on it
            results[case["name"]] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
