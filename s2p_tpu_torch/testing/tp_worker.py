"""One rank of the tensor-parallel generator checks: the CPU test
(``tests/test_torch_tp_generator.py``) and ``chip_smoke.py`` on the card.

``spawn_ranks(run, world, (spec_file, out_dir))`` builds a ``data=1 ×
model=world`` mesh over a gloo group, loads the spec's generator weights,
shards them with ``model_shard_params`` and runs one forward; each rank
saves ``{out_dir}/rank{r}.pt``: the output, the names of the sharded layers
with their weight shapes, and the MAT-norm kernel's launches in the
forward.

The spec (``torch.save``d) holds ``state_dim``, ``kwargs`` (the
generator's), ``g`` (its state dict), ``min_features``, ``state`` and
``prev_image`` (the inputs), and ``device`` (``cpu``, or ``cuda`` for every
rank on the one card; there TF32 is off, for an f32 comparison).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
import torch.distributed as dist

from s2p_tpu_torch.gan import cuda_kernels
from s2p_tpu_torch.gan.generator import S2PGenerator
from s2p_tpu_torch.parallel import MeshSpec, make_mesh, model_shard_params
from s2p_tpu_torch.parallel.distributed import initialize_distributed


def sharded_forward(mesh, gen: S2PGenerator, min_features: int, state, prev_image
                    ) -> Dict[str, Any]:
    """``gen`` sharded in place over ``mesh``'s model axis, and its forward on
    the inputs (on the generator's device): the output on the CPU, the MAT-norm
    kernel's launches in the forward, and the sharded layers' weight shapes
    by name."""
    gen = model_shard_params(mesh, gen, min_features)
    device = next(gen.parameters()).device
    state, prev = (torch.as_tensor(x, device=device) for x in (state, prev_image))
    launches = cuda_kernels.fused_mat_norm.launches
    with torch.no_grad():
        out = gen(state, prev)
    return dict(out=out.cpu(), launches=cuda_kernels.fused_mat_norm.launches - launches,
                sharded={name: tuple(m.weight.shape) for name, m in gen.named_modules()
                         if hasattr(m, "model_shard")})


def run(rank: int, world: int, init_method: str, spec_file: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = make_mesh(MeshSpec(data=1, model=world))
    spec = torch.load(spec_file, weights_only=False)
    gen = S2PGenerator(spec["state_dim"], device="cpu", **spec["kwargs"])
    gen.load_state_dict(spec["g"], strict=True)
    torch.save(sharded_forward(mesh, gen.to(spec["device"]), spec["min_features"],
                               spec["state"], spec["prev_image"]),
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
