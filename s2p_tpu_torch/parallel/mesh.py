"""Process mesh and sharding rules on ``torch.distributed``.

The port of ``s2p_tpu/parallel/mesh.py``. JAX lays a ``('data', 'model')``
mesh over devices and lets XLA insert the collectives that shardings
imply. The port runs one process per card, so the mesh is over ranks: a
``data × model`` grid (rank ``i·model + j`` at row i, column j, as JAX
reshapes its device list), with a process group along each axis, and the
collectives are written out where JAX's sharding implies them:

- 'data': the batch splits over the ranks of a column; gradients and
  metrics are averaged over them (``all_reduce_mean``);
- 'model': the widest generator layers keep a slice of their output
  features on each rank of a row, and gather the rest
  (``model_shard_params``).

In a single process there is no group: the mesh is 1 × 1 and every
collective is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from s2p_tpu_torch.utils.pyutil import treemap

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. ``-1`` means 'all remaining devices'."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int]:
        data, model = self.data, self.model
        if data == -1 and model == -1:
            raise ValueError("at most one axis may be -1")
        if model == -1:
            model = n_devices // max(data, 1)
        if data == -1:
            data = n_devices // max(model, 1)
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices"
            )
        return data, model


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: ``shape`` ({'data': d, 'model': m}),
    its coordinates, and the process group along each axis (the ranks that
    share its other coordinate; None without a process group)."""

    shape: Dict[str, int]
    ranks: List[List[int]]  # [data][model] → global rank
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]


def make_mesh(spec: MeshSpec = MeshSpec(), ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh over ``ranks`` (every rank of the default group when None).
    Every rank of the default group must call it, in the same order, since
    it creates the axis groups (``dist.new_group``)."""
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    ranks = list(range(world)) if ranks is None else list(ranks)
    data, model = spec.resolve(len(ranks))
    grid = [ranks[i * model:(i + 1) * model] for i in range(data)]
    me = dist.get_rank() if initialized else ranks[0]
    (row, col), = [(i, j) for i in range(data) for j in range(model) if grid[i][j] == me]
    groups: Dict[str, Optional[dist.ProcessGroup]] = {DATA_AXIS: None, MODEL_AXIS: None}
    if initialized:
        columns = [[grid[i][j] for i in range(data)] for j in range(model)]
        for axis, members, mine in ((DATA_AXIS, columns, col), (MODEL_AXIS, grid, row)):
            for k, group_ranks in enumerate(members):
                group = (dist.group.WORLD if sorted(group_ranks) == list(range(world))
                         else dist.new_group(group_ranks))
                if k == mine:
                    groups[axis] = group
    return Mesh({DATA_AXIS: data, MODEL_AXIS: model}, grid,
                {DATA_AXIS: row, MODEL_AXIS: col}, groups)


def local_device_count() -> int:
    return torch.cuda.device_count()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where an array lives on the mesh: ``spec[i]`` names the axis that
    splits dim i (None: replicated along it). A descriptor: the port moves
    data itself (``shard_batch``, ``shard_pytree``)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def batch_sharding(mesh: Mesh, ndim: int = 1, batch_dim: int = 0) -> NamedSharding:
    """Dimension ``batch_dim`` split over the data axis, the rest replicated."""
    spec = [None] * ndim
    spec[batch_dim] = DATA_AXIS
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_batch(mesh: Mesh, batch: Any, batch_dim: int = 0) -> Any:
    """This rank's part of a global host batch (a tree of arrays or
    tensors): of b rows, rank r of the data axis takes the contiguous rows
    [r·b/d, (r+1)·b/d), as ``P('data')`` lays them out. b must divide."""
    d, r = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]

    def take(x: Any) -> Any:
        b = x.shape[batch_dim]
        if b % d:
            raise ValueError(f"batch dim of {b} rows does not divide over {d} data ranks")
        idx = [slice(None)] * x.ndim
        idx[batch_dim] = slice(r * b // d, (r + 1) * b // d)
        return x[tuple(idx)]

    return treemap(take, batch)


def _state_tensors(obj: Any) -> List[torch.Tensor]:
    """The tensors of a module (parameters and buffers), an optimizer (its
    state, in parameter order) or a tree of tensors, in an order every rank
    agrees on."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, nn.Module):
        return list(obj.state_dict().values())
    if isinstance(obj, torch.optim.Optimizer):
        return [t for group in obj.param_groups for p in group["params"]
                for t in _state_tensors(obj.state.get(p, {}))]
    if isinstance(obj, Mapping):
        return [t for v in obj.values() for t in _state_tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _state_tensors(v)]
    return []


def shard_pytree(mesh: Mesh, obj: Any) -> Any:
    """Replicate ``obj`` (a module, an optimizer or a tree of tensors) over
    the mesh: every rank's tensors are overwritten in place with those of
    the mesh's first rank, so all hold the same parameters and optimizer
    state. Returns ``obj``."""
    if not dist.is_initialized():
        return obj
    nccl = dist.get_backend() == "nccl"
    src = mesh.ranks[0][0]
    for t in _state_tensors(obj):
        if nccl and not t.is_cuda:  # NCCL moves CUDA tensors only
            staged = t.to(torch.cuda.current_device())
            dist.broadcast(staged, src)
            t.copy_(staged)
        else:
            dist.broadcast(t.data, src)
    return obj


def state_checksum(*objs: Any) -> int:
    """An integer that changes with any bit of the tensors of ``objs`` (as
    ``shard_pytree`` finds them): each tensor's bits summed as integers,
    weighted by its position."""
    total = 0
    for i, t in enumerate(t for obj in objs for t in _state_tensors(obj)):
        flat = t.detach().reshape(-1)
        bits = flat.view(torch.int32) if flat.element_size() == 4 else flat.view(torch.uint8)
        total += (i + 1) * int(bits.sum(dtype=torch.int64))
    return total


def all_reduce_mean(tensors: Sequence[torch.Tensor],
                    group: Optional[dist.ProcessGroup]) -> List[torch.Tensor]:
    """The mean of each tensor over ``group``'s ranks, through one
    all-reduce of one flat buffer (views of it, shaped as the inputs; the
    inputs themselves without a group)."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return [f.view(t.shape) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def sync_grads(grads: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup]) -> None:
    """Average ``grads`` in place over ``group``'s ranks: one all-reduce of
    one flat buffer, then the copies back; nothing without a group."""
    if group is not None:
        for g, mean in zip(grads, all_reduce_mean(grads, group)):
            g.copy_(mean)


def mean_metrics(metrics: Dict[str, torch.Tensor], group: Optional[dist.ProcessGroup]
                 ) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over ``group``'s ranks (one all-reduce);
    ``metrics`` itself without a group."""
    if group is None:
        return metrics
    return dict(zip(metrics, all_reduce_mean(list(metrics.values()), group)))


def rank_seed(seed: int, group: Optional[dist.ProcessGroup]) -> int:
    """The seed of this rank's random stream: ``seed`` at rank 0 of
    ``group`` (or without one), a distinct 32-bit seed at every other rank
    (a CPU generator keeps only the low 32 bits of its seed)."""
    rank = dist.get_rank(group) if group is not None else 0
    return (seed + 0x9E3779B9 * rank) % 2**32


def all_gather_cat(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along ``dim`` in rank
    order (gathered on a view with ``dim`` last, which is a channels_last
    activation's own layout)."""
    x = x.movedim(dim, -1).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1).movedim(-1, dim)


def model_shard_params(mesh: Mesh, module: nn.Module, min_features: int = 256) -> nn.Module:
    """Tensor parallelism over the 'model' axis, forward only, in place.

    Each conv or dense layer whose output features number ≥
    ``min_features`` and divide over the axis keeps only this rank's
    contiguous slice of them (weight rows and bias), computes that slice of
    channels, and gathers the others' slices before returning, so every
    consumer sees the full tensor (the generator's MAT norms run on full,
    gathered tensors). ``layer.model_shard`` holds (this rank's index, axis
    size) on each sharded layer. On a model=1 mesh nothing changes.
    """
    n = mesh.shape[MODEL_AXIS]
    if n == 1:
        return module
    group, index = mesh.groups[MODEL_AXIS], mesh.coords[MODEL_AXIS]
    for layer in module.modules():
        if isinstance(layer, nn.Conv2d):
            dim, attr = 1, "out_channels"
        elif isinstance(layer, nn.Linear):
            dim, attr = -1, "out_features"
        else:
            continue
        out = getattr(layer, attr)
        if out < min_features or out % n:
            continue
        keep = slice(index * out // n, (index + 1) * out // n)
        with torch.no_grad():
            layer.weight = nn.Parameter(layer.weight[keep].clone(), requires_grad=False)
            if layer.bias is not None:
                layer.bias = nn.Parameter(layer.bias[keep].clone(), requires_grad=False)
        setattr(layer, attr, out // n)
        layer.model_shard = (index, n)
        layer.register_forward_hook(
            lambda _m, _inp, y, dim=dim: all_gather_cat(y, dim, group))
    return module
