"""The port's nn library (s2p_tpu_torch.nn) against the JAX package's.

Seeded numpy weights (a flax ``params`` tree from ``jax.eval_shape``) go
into both packages; f32 on the CPU, rtol = atol = 1e-5 unless stated."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.nn import CNN as JaxCNN
from s2p_tpu.nn import DCNN as JaxDCNN
from s2p_tpu.nn import ConcatMlp as JaxConcatMlp
from s2p_tpu.nn import Mlp as JaxMlp
from s2p_tpu.nn import MultiHeadedMlp as JaxMultiHeadedMlp
from s2p_tpu.nn import distributions as jd
from s2p_tpu.nn.cnn import ConvTranspose2dTorch as JaxConvTranspose
from s2p_tpu.slac.latent import _DECODER_CFG
from s2p_tpu_torch.nn import (
    CNN,
    DCNN,
    ConcatMlp,
    ConvTranspose2dTorch,
    Delta,
    Mlp,
    MultiHeadedMlp,
    Normal,
    TanhNormal,
    fanin_uniform_,
    uniform_bias,
    xavier_uniform_,
)
from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict, state_dict_from_jax_dense_tree
from tests.test_torch_generator import seeded_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _carry(module, params):
    module.load_state_dict(state_dict_from_jax_dense_tree(params), strict=True)
    return module


@pytest.mark.parametrize("layer_norm", [False, True])
def test_mlp_matches_jax(layer_norm):
    """LayerNorm on every hidden layer but the last (the reference's quirk)."""
    x = np.random.RandomState(0).randn(5, 7).astype(np.float32)
    jm = JaxMlp(hidden_sizes=(16, 12, 8), output_size=3, layer_norm=layer_norm)
    params = seeded_params(jm.init, jnp.zeros((1, 7)))
    m = _carry(Mlp(7, (16, 12, 8), 3, layer_norm=layer_norm), params)
    assert sorted(n for n, _ in m.named_children()) == sorted(params)
    assert ("layer_norm1" in params) == layer_norm and "layer_norm2" not in params
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    with torch.no_grad():
        np.testing.assert_allclose(m(_t(x)).numpy(), ref, **TOL)


def test_concat_mlp_and_multiheaded_mlp_match_jax():
    rs = np.random.RandomState(1)
    a, b = rs.randn(4, 5).astype(np.float32), rs.randn(4, 2).astype(np.float32)
    jm = JaxConcatMlp(hidden_sizes=(8, 8), output_size=1)
    params = seeded_params(jm.init, jnp.zeros((1, 5)), jnp.zeros((1, 2)))
    m = _carry(ConcatMlp(7, (8, 8), 1), params)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, a, b))
    with torch.no_grad():
        np.testing.assert_allclose(m(_t(a), _t(b)).numpy(), ref, **TOL)

    jh = JaxMultiHeadedMlp(hidden_sizes=(8, 6), output_sizes=(2, 3), layer_norm=True)
    params = seeded_params(jh.init, jnp.zeros((1, 5)))
    h = _carry(MultiHeadedMlp(5, (8, 6), (2, 3), layer_norm=True), params)
    refs = jax.jit(jh.apply)({"params": params}, a)
    with torch.no_grad():
        for got, r in zip(h(_t(a)), refs):
            np.testing.assert_allclose(got.numpy(), np.asarray(r), **TOL)


def test_tanh_normal_log_prob_at_the_bounds_and_inside():
    """±1 actions are clipped to ±(1 − 1e-6) before atanh, so they stay
    finite; inside, the stable log-det matches JAX."""
    rs = np.random.RandomState(2)
    loc, scale = rs.randn(6, 3).astype(np.float32), np.exp(rs.randn(6, 3)).astype(np.float32)
    a = np.tanh(rs.randn(6, 3)).astype(np.float32)
    a[0] = [1.0, -1.0, 0.5]
    a[1] = [-1.0, -1.0, 1.0]
    ref = np.asarray(jd.TanhNormal(jnp.asarray(loc), jnp.asarray(scale)).log_prob(jnp.asarray(a)))
    got = TanhNormal(_t(loc), _t(scale)).log_prob(_t(a)).numpy()
    assert np.isfinite(got).all() and got.shape == (6,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_tanh_normal_sample_with_given_eps_matches_jax():
    rs = np.random.RandomState(3)
    loc, scale = rs.randn(4, 2).astype(np.float32), np.exp(rs.randn(4, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    dist = jd.TanhNormal(jnp.asarray(loc), jnp.asarray(scale))
    eps = np.asarray(jax.random.normal(key, (4, 2)))
    ref_a, ref_lp = dist.sample_and_log_prob(key)
    got_a, got_lp = TanhNormal(_t(loc), _t(scale)).sample_and_log_prob(eps=_t(eps))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), **TOL)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(ref_lp), **TOL)
    np.testing.assert_allclose(TanhNormal(_t(loc), _t(scale)).sample(eps=_t(eps)).numpy(),
                               np.asarray(dist.sample(key)), **TOL)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    port = TanhNormal(_t(loc), _t(scale))
    assert torch.equal(port.sample(g1), port.sample(g2))


def test_normal_and_delta_match_jax():
    rs = np.random.RandomState(4)
    loc, scale, x = (rs.randn(3, 4).astype(np.float32) for _ in range(3))
    scale = np.abs(scale) + 0.1
    jn, n = jd.Normal(jnp.asarray(loc), jnp.asarray(scale)), Normal(_t(loc), _t(scale))
    np.testing.assert_allclose(n.log_prob(_t(x)).numpy(), np.asarray(jn.log_prob(x)), **TOL)
    np.testing.assert_allclose(n.entropy().numpy(), np.asarray(jn.entropy()), **TOL)
    other = jd.Normal(jnp.asarray(x), jnp.asarray(scale[::-1].copy()))
    np.testing.assert_allclose(
        n.kl_divergence(Normal(_t(x), _t(scale[::-1].copy()))).numpy(),
        np.asarray(jn.kl_divergence(other)), **TOL)
    d, jdelta = Delta(_t(loc)), jd.Delta(jnp.asarray(loc))
    probe = loc.copy()
    probe[1, 0] += 1.0
    np.testing.assert_array_equal(d.log_prob(_t(probe)).numpy(),
                                  np.asarray(jdelta.log_prob(probe)))
    assert torch.equal(d.mode, _t(loc)) and torch.equal(d.sample(), _t(loc))


def _deconv_layers():
    """(image size, layer, input H=W) of every layer of both decoder chains."""
    out = []
    for size, cfg in _DECODER_CFG.items():
        hw = 1
        for i, (_, k, s, p, op) in enumerate(cfg):
            out.append((size, i, hw))
            hw = (hw - 1) * s - 2 * p + k + op
        assert hw == size
    return out


@pytest.mark.parametrize("size,layer,hw", _deconv_layers())
def test_conv_transpose_matches_jax_on_every_decoder_layer(size, layer, hw):
    """torch's ConvTranspose2d with output_padding is the JAX module; the
    un-flipped HWIO kernel becomes IOHW by ``transpose(2, 3, 0, 1)``."""
    _, k, s, p, op = _DECODER_CFG[size][layer]
    x = np.random.RandomState(layer).randn(2, hw, hw, 3).astype(np.float32)
    jm = JaxConvTranspose(4, kernel_size=k, stride=s, padding=p, output_padding=op)
    params = seeded_params(jm.init, jnp.zeros((1, hw, hw, 3)), seed=layer)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    m = ConvTranspose2dTorch(3, 4, k, s, p, op)
    m.load_state_dict(dict(weight=_t(params["kernel"].transpose(2, 3, 0, 1)),
                           bias=_t(params["bias"])), strict=True)
    with torch.no_grad():
        got = m(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("norm,pool_every", [(None, 0), ("layer", 1), ("group", 2)])
def test_cnn_matches_jax(norm, pool_every):
    x = np.random.RandomState(5).rand(2, 3, 20, 20, 3).astype(np.float32)
    kw = dict(channels=(8, 16), kernel_sizes=(3, 3), strides=(1, 2), paddings=(1, 1),
              hidden_sizes=(12,), output_size=5, norm=norm, pool_every=pool_every)
    jm = JaxCNN(**kw)
    params = seeded_params(jm.init, jnp.zeros((1, 20, 20, 3)))
    m = _carry(CNN((20, 20, 3), **kw), params)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    with torch.no_grad():
        got = m(_t(x)).numpy()
    assert got.shape == ref.shape == (2, 3, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def test_dcnn_matches_jax_and_round_trips():
    x = np.random.RandomState(6).randn(3, 6).astype(np.float32)
    kw = dict(fc_hidden_sizes=(16,), deconv_input_shape=(4, 4, 5), channels=(6, 3),
              kernel_sizes=(3, 5), strides=(2, 2), paddings=(1, 2))
    jm = JaxDCNN(**kw)
    params = seeded_params(jm.init, jnp.zeros((1, 6)))
    m = _carry(DCNN(6, **kw), params)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    with torch.no_grad():
        np.testing.assert_allclose(m(_t(x)).numpy(), ref, **TOL)
    back = jax_dense_tree_from_state_dict(m.state_dict())["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_initializers_bounds_and_determinism():
    w = torch.empty(64, 50)
    fanin_uniform_(w, torch.Generator().manual_seed(0))
    assert w.abs().max() <= 1 / np.sqrt(50) and w.std() > 0.5 / np.sqrt(3 * 50)
    v = torch.empty(64, 50)
    fanin_uniform_(v, torch.Generator().manual_seed(0))
    assert torch.equal(w, v)
    c = torch.empty(8, 4, 3, 3)
    xavier_uniform_(c, torch.Generator().manual_seed(1))
    assert c.abs().max() <= np.sqrt(6 / (4 * 9 + 8 * 9))
    assert torch.equal(uniform_bias(torch.empty(3)), torch.full((3,), 0.1))
    m = Mlp(5, (7,), 2, init_w=1e-3, seed=3)
    assert m.last_fc.weight.abs().max() <= 1e-3 and not m.last_fc.bias.any()
    assert torch.equal(m.fc0.weight, Mlp(5, (7,), 2, seed=3).fc0.weight)
