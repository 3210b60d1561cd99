"""Tensor parallelism of the generator (``model_shard_params``) on 2 gloo
ranks on the CPU, at the configuration of the JAX package's own test
(``tests/test_parallel.py::test_model_shard_params_tensor_parallel_generator``:
image 32, ngf 32, state embed 64, MAT hidden 64, 2 frequencies, 2
upsamplings, ``min_features`` 64): each rank's sharded forward equals JAX's
replicated forward with the same parameters within 2e-5, the bound of
JAX's test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.gan import S2PGenerator as JaxGenerator
from s2p_tpu_torch.gan.convert import state_dict_from_jax_params
from s2p_tpu_torch.parallel.distributed import spawn_ranks
from s2p_tpu_torch.testing import tp_worker

from test_torch_generator import STATE_DIM, seeded_params

KW = dict(image_size=32, ngf=32, state_embed_dim=64, mat_hidden=64, state_freqs=2, n_up=2)
WORLD, MIN_FEATURES = 2, 64


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    jgen = JaxGenerator(**KW)
    s = np.random.RandomState(0).randn(4, STATE_DIM).astype(np.float32)
    img = (np.random.RandomState(1).rand(4, 32, 32, 3) * 2 - 1).astype(np.float32)
    params = seeded_params(jgen.init, jnp.zeros((1, STATE_DIM)), jnp.zeros((1, 32, 32, 3)))
    spec = dict(state_dim=STATE_DIM, kwargs=KW, g=state_dict_from_jax_params(params),
                min_features=MIN_FEATURES, state=s, prev_image=img, device="cpu")
    torch.save(spec, tmp / "spec.pt")
    spawn_ranks(tp_worker.run, WORLD, (str(tmp / "spec.pt"), str(tmp)), timeout=240)
    ref = np.asarray(jax.jit(jgen.apply)({"params": params}, s, img))
    return ref, spec, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                       for r in range(WORLD)]


def test_sharded_forward_matches_jax_replicated(run):
    ref, _, ranks = run
    for res in ranks:
        np.testing.assert_allclose(res["out"].numpy(), ref, rtol=2e-5, atol=2e-5)


def test_wide_layers_keep_their_slice_of_output_features(run):
    _, spec, ranks = run
    sharded = ranks[0]["sharded"]
    assert sharded and sharded == ranks[1]["sharded"]
    for name, shape in sharded.items():
        full = spec["g"][f"{name}.weight"].shape
        assert full[0] >= MIN_FEATURES and shape == (full[0] // WORLD, *full[1:]), name
    # every other conv or dense weight kept whole: its output dim is narrow
    for key, w in spec["g"].items():
        name = key.rsplit(".", 1)[0]
        if key.endswith(".weight") and name not in sharded:
            assert w.shape[0] < MIN_FEATURES, key
