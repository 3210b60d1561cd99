"""The port's mesh and bootstrap (``s2p_tpu_torch/parallel``) against the
JAX package's, in one process: ``MeshSpec``, the single-process helpers,
``shard_batch``'s rows against JAX's shards on the 8-device CPU mesh
(data 4 × model 2), and the identities a 1 × 1 mesh must be."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from s2p_tpu.parallel import MeshSpec as JaxMeshSpec
from s2p_tpu.parallel import shard_batch as jax_shard_batch
from s2p_tpu_torch.gan.generator import S2PGenerator
from s2p_tpu_torch.parallel import (
    Mesh, MeshSpec, all_reduce_mean, batch_sharding, local_device_count, make_mesh,
    model_shard_params, replicated, shard_batch, shard_pytree, state_checksum)
from s2p_tpu_torch.parallel.distributed import (
    free_port, global_mesh, host_local_batch_slice, initialize_distributed, ranks_backend)

from test_torch_generator import KW, STATE_DIM

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE")


@pytest.fixture
def single_process(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()


@pytest.mark.parametrize("data,model,n", [
    (-1, 2, 8), (8, 1, 8), (-1, 1, 1), (2, -1, 8), (1, -1, 4), (4, 2, 8),
    (3, 2, 8), (-1, -1, 4), (-1, 3, 8), (2, 2, 2)])
def test_mesh_spec_resolve_matches_jax(data, model, n):
    try:
        want = JaxMeshSpec(data=data, model=model).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" does")[0]):
            MeshSpec(data=data, model=model).resolve(n)
    else:
        assert MeshSpec(data=data, model=model).resolve(n) == want


def test_single_process_helpers(single_process):
    assert initialize_distributed() is False and not dist.is_initialized()
    assert host_local_batch_slice(32) == slice(0, 32)
    mesh = global_mesh(data=-1, model=1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {"data": None, "model": None}
    assert mesh.coords == {"data": 0, "model": 0} and mesh.ranks == [[0]]
    assert local_device_count() == torch.cuda.device_count()
    assert batch_sharding(mesh, 3, 1).spec == (None, "data", None)
    assert replicated(mesh).spec == ()


def test_initialize_distributed_reads_the_torchrun_environment(single_process, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert initialize_distributed(backend="gloo") is True
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        mesh = make_mesh()
        assert mesh.groups["data"] is dist.group.WORLD  # a real (one-rank) group
        x = torch.arange(4.0)
        assert torch.equal(all_reduce_mean([x], mesh.groups["data"])[0], x)
    finally:
        dist.destroy_process_group()


def test_a_failed_nccl_init_raises_and_never_falls_back(single_process):
    """This build has no NCCL (and no card): the init raises, and no gloo
    group is created in its place."""
    with pytest.raises((RuntimeError, ValueError)):
        initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                               device=torch.device("cuda", 0))
    assert not dist.is_initialized()


def test_backend_choice():
    cuda = lambda i: torch.device("cuda", i)
    assert ranks_backend([cuda(0), cuda(1)]) == "nccl"
    assert ranks_backend([cuda(0)]) == "nccl"
    assert ranks_backend([cuda(0), cuda(0)]) == "gloo"  # NCCL refuses two ranks on a card
    assert ranks_backend([torch.device("cpu")] * 2) == "gloo"


def test_shard_batch_rows_match_jax_shards(mesh8):
    """Rank r of a 4-way data axis takes the rows JAX's ``P('data')`` puts
    on the devices of data index r."""
    rs = np.random.RandomState(0)
    batch = {"obs": rs.randn(8, 5).astype(np.float32), "rew": rs.randn(8).astype(np.float32)}
    placed = jax_shard_batch(mesh8, batch)
    for r in range(4):
        mesh = Mesh({"data": 4, "model": 1}, [[i] for i in range(4)], {"data": r, "model": 0},
                    {"data": None, "model": None})
        ours = shard_batch(mesh, batch)
        for k, arr in placed.items():
            shard = next(s for s in arr.addressable_shards if s.index[0].start == 2 * r)
            np.testing.assert_array_equal(ours[k], np.asarray(shard.data))
        tensors = shard_batch(mesh, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert torch.equal(tensors["obs"], torch.from_numpy(ours["obs"]))
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, {"x": np.zeros((6, 2))})


def test_model_one_mesh_changes_nothing(single_process):
    mesh = make_mesh(MeshSpec(data=1, model=1))
    gen = S2PGenerator(STATE_DIM, image_size=16, device="cpu", **KW)
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    assert model_shard_params(mesh, gen, min_features=1) is gen
    after = gen.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not any(hasattr(m, "model_shard") for m in gen.modules())
    assert not gen.seed_fc._forward_hooks
    # and the other identities of a mesh without a process group
    assert shard_pytree(mesh, gen) is gen
    xs = [torch.ones(2), torch.zeros(3)]
    assert all_reduce_mean(xs, None)[0] is xs[0]


def test_state_checksum_sees_every_bit():
    a = {"w": torch.linspace(-1, 1, 10), "b": torch.arange(3, dtype=torch.int64)}
    base = state_checksum(a)
    assert state_checksum({k: v.clone() for k, v in a.items()}) == base
    flipped = a["w"].clone()
    flipped.view(torch.int32)[4] ^= 1  # the lowest mantissa bit of one entry
    assert state_checksum({"w": flipped, "b": a["b"]}) != base
    assert state_checksum({"b": a["b"], "w": a["w"]}) != base  # order counts
