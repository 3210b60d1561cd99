"""The port's multiscale discriminator against the JAX package: the same
seeded numpy weights go into both (a JAX ``params`` tree carried over by
``state_dict_from_jax_params``); f32 on the CPU, rtol = atol = 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.gan.discriminator import MultiscaleDiscriminator as JaxDiscriminator
from s2p_tpu.gan.discriminator import avg_pool_2x as jax_avg_pool_2x
from s2p_tpu_torch.gan.convert import state_dict_from_jax_params
from s2p_tpu_torch.gan.discriminator import MultiscaleDiscriminator, avg_pool_2x

from test_torch_generator import STATE_DIM, seeded_params

D_KW = dict(ndf=8, n_layers=2, num_scales=2)


def disc_params(jdisc: JaxDiscriminator, size: int, seed: int = 0):
    s = jnp.zeros((2, STATE_DIM))
    img = jnp.zeros((2, size, size, 3))
    return seeded_params(jdisc.init, s, img, img, seed=seed)


def make_disc_pair(size: int, seed: int = 0, **kw):
    kw = {**D_KW, **kw}
    jdisc = JaxDiscriminator(**kw)
    params = disc_params(jdisc, size, seed)
    disc = MultiscaleDiscriminator(STATE_DIM, device="cpu", **kw)
    disc.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jdisc, params, disc


@pytest.mark.parametrize("size", [16, 25])
def test_avg_pool_2x_matches_jax(size):
    x = np.random.RandomState(size).randn(2, size, size, 5).astype(np.float32)
    ref = np.asarray(jax_avg_pool_2x(jnp.asarray(x)))
    out = avg_pool_2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("size", [16, 25])
def test_discriminator_matches_jax(size, n_layers):
    """Every feature map and the logits of every scale, at an even and an
    odd image size."""
    jdisc, params, disc = make_disc_pair(size, n_layers=n_layers)
    rs = np.random.RandomState(1)
    s = rs.randn(2, STATE_DIM).astype(np.float32)
    prev, img = ((rs.rand(2, size, size, 3) * 2 - 1).astype(np.float32) for _ in range(2))
    ref = jax.jit(jdisc.apply)({"params": params}, s, prev, img)
    with torch.no_grad():
        out = disc(*map(torch.from_numpy, (s, prev, img)))
    assert len(out) == len(ref) == 2
    for fs, rfs in zip(out, ref):
        assert len(fs) == len(rfs) == n_layers + 1
        for f, r in zip(fs, rfs):
            assert tuple(f.shape) == r.shape
            np.testing.assert_allclose(f.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_state_dict_names_equal_the_flax_tree():
    _, params, disc = make_disc_pair(16)
    sd = state_dict_from_jax_params(params)
    assert sorted(sd) == sorted(disc.state_dict())
    assert "scale1.conv_out.bias" in sd and "scale0.conv1.bias" not in sd
    bad = dict(sd)
    bad["scale0.conv1.bias"] = torch.zeros(16)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        disc.load_state_dict(bad, strict=True)


def test_seeded_init_is_deterministic():
    a, b, c = (MultiscaleDiscriminator(STATE_DIM, seed=s, device="cpu", **D_KW)
               for s in (1, 1, 2))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        assert k.endswith("bias") and not va.any() or not torch.equal(va, vc), k
