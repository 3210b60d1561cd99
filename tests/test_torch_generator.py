"""The port's generator (s2p_tpu_torch) against the JAX reference.

The same seeded numpy weights go into both packages: a JAX ``params`` tree
with numpy leaves, carried into the port by ``state_dict_from_jax_params``.
Tiny widths, f32 on the CPU, rtol = atol = 1e-4 (as the torch-twin parity
tests in test_convert.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.gan import S2PGenerator as JaxGenerator
from s2p_tpu.gan.generator import instance_norm as jax_instance_norm
from s2p_tpu.gan.generator import upsample_nearest as jax_upsample_nearest
from s2p_tpu_torch.gan import S2PGenerator, resolution_chain
from s2p_tpu_torch.gan.convert import state_dict_from_jax_params
from s2p_tpu_torch.gan.generator import instance_norm, upsample_nearest

STATE_DIM = 17
KW = dict(ngf=8, state_freqs=2, state_embed_dim=16, mat_hidden=8)


def seeded_params(init, *example, seed: int = 0):
    """Seeded numpy weights in the shape of a flax module's params (from
    ``jax.eval_shape`` of its ``init``): LeCun-scaled kernels and small
    non-zero biases (so every bias path is exercised)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *example)["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, sd):
        if path[-1].key == "bias":
            return (0.1 * rs.randn(*sd.shape)).astype(np.float32)
        return (rs.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_params(gen: JaxGenerator, batch: int = 2, seed: int = 0):
    size = gen.image_size
    return seeded_params(gen.init, jnp.zeros((batch, STATE_DIM)),
                         jnp.zeros((batch, size, size, 3)), seed=seed)


def make_pair(size: int = 64, mat_mode: str = "mat", seed: int = 0):
    """(JAX generator, its numpy params, the port's generator with the
    same weights on the CPU)."""
    jgen = JaxGenerator(image_size=size, mat_mode=mat_mode, **KW)
    params = jax_params(jgen, seed=seed)
    gen = S2PGenerator(STATE_DIM, image_size=size, mat_mode=mat_mode, device="cpu", **KW)
    gen.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jgen, params, gen


def inputs(size: int, batch: int = 2, seed: int = 0):
    rs = np.random.RandomState(seed)
    s = rs.randn(batch, STATE_DIM).astype(np.float32)
    img = (rs.rand(batch, size, size, 3) * 2 - 1).astype(np.float32)
    return s, img


@pytest.mark.parametrize("mat_mode", ["mat", "sat_state", "sat_image"])
@pytest.mark.parametrize("size", [64, 25])
def test_generator_matches_jax(size, mat_mode):
    """64px and the odd 25 → 13 → 7 → 4 → 2 chain (non-2× nearest steps)."""
    jgen, params, gen = make_pair(size, mat_mode)
    s, img = inputs(size)
    ref = np.asarray(jax.jit(jgen.apply)({"params": params}, s, img))
    with torch.no_grad():
        out = gen(torch.from_numpy(s), torch.from_numpy(img)).numpy()
    assert out.shape == ref.shape == (2, size, size, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_state_dict_names_equal_the_flax_tree():
    """Every flax leaf has exactly one port parameter of the same path and
    the torch layout of its shape; the load is strict."""
    _, params, gen = make_pair()
    sd = state_dict_from_jax_params(params)
    own = gen.state_dict()
    assert sorted(sd) == sorted(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in own)
    assert "block_1.norm_s.mlp_shared.weight" in own and "block_1.conv_s.bias" not in own
    bad = dict(sd)
    bad["block_0.norm_0.mlp_gamma.extra"] = bad["conv_img.bias"]
    with pytest.raises(RuntimeError, match="Unexpected key"):
        gen.load_state_dict(bad, strict=True)


def test_seeded_init_is_deterministic_and_flax_scaled():
    a = S2PGenerator(STATE_DIM, device="cpu", seed=3, **KW)
    b = S2PGenerator(STATE_DIM, device="cpu", seed=3, **KW)
    c = S2PGenerator(STATE_DIM, device="cpu", seed=4, **KW)
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith("bias"):
            assert not va.any(), k
        else:
            assert not torch.equal(va, vc), k
            fan_in = va[0].numel()
            assert va.abs().max() <= 2 / np.sqrt(fan_in) / 0.8796 + 1e-6, k


@pytest.mark.parametrize("n_in,n_out", [(2, 4), (4, 7), (7, 13), (13, 25), (25, 50)])
def test_upsample_nearest_matches_jax(n_in, n_out):
    x = np.random.RandomState(n_in).randn(2, n_in, n_in, 3).astype(np.float32)
    ref = np.asarray(jax_upsample_nearest(jnp.asarray(x), n_out))
    out = upsample_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), n_out)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("size", [64, 100, 25])
def test_resolution_chain_and_block_layout(size):
    jgen = JaxGenerator(image_size=size, **KW)
    gen = S2PGenerator(STATE_DIM, image_size=size, device="cpu", **KW)
    assert resolution_chain(size, 4) == [size] + jgen.sizes[::-1][1:]
    assert gen.sizes == jgen.sizes
    assert gen.block_channels == jgen.block_channels
    assert gen.encoder_channels == jgen.encoder_channels


def test_instance_norm_matches_jax():
    x = (3.0 + np.random.RandomState(5).randn(2, 13, 13, 12)).astype(np.float32)
    ref = np.asarray(jax_instance_norm(jnp.asarray(x)))
    out = instance_norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
