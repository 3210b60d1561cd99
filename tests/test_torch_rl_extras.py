"""The port's RL-side nn pieces against the JAX package's: the linear
transform (exact), the Gaussian mixture (1e-6, ``sample`` on JAX's draws),
the scaled orthogonal initializer (the property both hold: orthonormal
rows or columns times the gain), the VAE policy and its ELBO (converted
weights, JAX's noise, 1e-5) and ``PolicyFromQ``'s argmax-Q choice."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.nn.initializers import scaled_orthogonal as jax_scaled_orthogonal
from s2p_tpu.nn.linear_transform import LinearTransform as JaxLinearTransform
from s2p_tpu.nn.mixture import GaussianMixture as JaxGaussianMixture
from s2p_tpu.rl.vae_policy import VAEPolicy as JaxVAEPolicy
from s2p_tpu.rl.vae_policy import elbo_loss as jax_elbo_loss
from s2p_tpu_torch.nn import GaussianMixture, LinearTransform, scaled_orthogonal_
from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict
from s2p_tpu_torch.rl import (PolicyFromQ, TanhGaussianPolicy, VAEPolicy, elbo_loss,
                              state_dict_from_jax_vae_params)
from tests.test_torch_generator import seeded_params

OBS, ACT, LATENT, HIDDEN, B = 5, 3, 2, 32, 6
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,b", [(1.0, 0.0), (2.0, 0.5), (-0.3, 1.7)])
def test_linear_transform_is_exact(m, b):
    x = np.random.RandomState(0).randn(7, 1).astype(np.float32)
    got = LinearTransform(m, b)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JaxLinearTransform(m, b)(jnp.asarray(x))))


def mixture(seed=0, batch=4, dim=3, k=5):
    rs = np.random.RandomState(seed)
    w = rs.rand(batch, k).astype(np.float32)
    arrays = dict(means=rs.randn(batch, dim, k).astype(np.float32),
                  stds=(rs.rand(batch, dim, k) + 0.3).astype(np.float32),
                  weights=w / w.sum(-1, keepdims=True))
    return (JaxGaussianMixture(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            GaussianMixture(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def test_gaussian_mixture_densities_and_estimates_match_jax():
    jm, m = mixture()
    x = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    np.testing.assert_allclose(m.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.log_prob(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    for got, ref in ((m.mle_estimate(), jm.mle_estimate()), (m.mode, jm.mode),
                     (m.mean, jm.mean)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert m.num_gaussians == jm.num_gaussians == 5


def test_gaussian_mixture_sample_on_jax_draws():
    """``sample(key)`` draws the components' normals from split(key)[0] and
    the component from split(key)[1]; the port takes both as given."""
    jm, m = mixture(seed=2)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    eps = np.array(jax.random.normal(k1, jm.means.shape))
    comp = np.array(jax.random.categorical(k2, jnp.log(jm.weights + 1e-12)))
    got = m.sample(eps=torch.from_numpy(eps), component=torch.from_numpy(comp).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.sample(key)), rtol=1e-6, atol=1e-6)
    drawn = m.sample(torch.Generator().manual_seed(0))
    assert drawn.shape == (4, 3) and torch.isfinite(drawn).all()


def test_gaussian_mixture_samples_its_heavy_component():
    """Two well-separated components with weights 0.99/0.01: the estimates
    and the samples sit at the heavy one (JAX's test of the same)."""
    means = torch.stack([torch.zeros(2, 3), 10 * torch.ones(2, 3)], dim=-1)
    m = GaussianMixture(means, torch.full((2, 3, 2), 0.1), torch.tensor([[0.99, 0.01],
                                                                          [0.01, 0.99]]))
    np.testing.assert_allclose(m.mle_estimate().numpy(), [[0] * 3, [10] * 3], atol=1e-6)
    s = m.sample(torch.Generator().manual_seed(0))
    assert abs(s[0].mean()) < 2 and abs(s[1].mean() - 10) < 2


@pytest.mark.parametrize("shape", [(4, 8), (8, 4), (6, 6), (8, 3, 3, 3)])
@pytest.mark.parametrize("gain", [1.0, 1.41421356])
def test_scaled_orthogonal_is_orthogonal_times_its_gain(shape, gain):
    """The weight flattened past its first axis has orthonormal rows (or
    columns, when there are fewer of them) times the gain; JAX's
    initializer of the flax kernel of the same layer holds the same."""
    w = scaled_orthogonal_(torch.empty(shape), torch.Generator().manual_seed(0), gain)
    flat = w.reshape(shape[0], -1).double()
    gram = flat @ flat.T if flat.shape[0] <= flat.shape[1] else flat.T @ flat
    np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(len(gram)), atol=1e-5)
    flax_shape = (int(np.prod(shape[1:])), shape[0])  # (in, out)
    k = np.asarray(jax_scaled_orthogonal(gain)(jax.random.PRNGKey(0), flax_shape), np.float64)
    ref = k.T @ k if k.shape[1] <= k.shape[0] else k @ k.T
    np.testing.assert_allclose(ref, gain ** 2 * np.eye(len(ref)), atol=1e-5)
    assert not torch.equal(w, scaled_orthogonal_(torch.empty(shape),
                                                 torch.Generator().manual_seed(1), gain))


@pytest.fixture(scope="module")
def vae():
    jm = JaxVAEPolicy(obs_dim=OBS, action_dim=ACT, latent_dim=LATENT, hidden=HIDDEN,
                      max_action=2.0)
    rs = np.random.RandomState(4)
    s = rs.randn(B, OBS).astype(np.float32)
    a = np.tanh(rs.randn(B, ACT)).astype(np.float32)
    params = seeded_params(jm.init, s, a, jax.random.PRNGKey(1), seed=5)
    m = VAEPolicy(OBS, ACT, LATENT, hidden=HIDDEN, max_action=2.0)
    m.load_state_dict(state_dict_from_jax_vae_params({"params": params}), strict=True)
    return jm, {"params": params}, m, s, a


def test_vae_policy_names_and_converters_round_trip(vae):
    jm, params, m, _, _ = vae
    assert sorted(dict(m.named_children())) == sorted(["e1", "e2", "mean", "log_std", "d1",
                                                       "d2", "d3"])
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax_dense_tree_from_state_dict(m.state_dict()), params)
    fresh = VAEPolicy(OBS, ACT, LATENT, hidden=HIDDEN, seed=1)
    assert torch.equal(fresh.d3.bias, torch.zeros(ACT))
    assert not torch.equal(fresh.e1.weight, VAEPolicy(OBS, ACT, LATENT, hidden=HIDDEN).e1.weight)


def test_vae_policy_forward_and_elbo_match_jax(vae):
    jm, params, m, s, a = vae
    key = jax.random.PRNGKey(6)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, LATENT))))
    ref = jm.apply(params, s, a, key)
    with torch.no_grad():
        got = m(torch.from_numpy(s), torch.from_numpy(a), eps=eps)
        loss = elbo_loss(m, torch.from_numpy(s), torch.from_numpy(a), eps=eps)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(loss.item(), float(jax_elbo_loss(jm, params, s, a, key)), **TOL)


def test_vae_policy_log_std_is_clamped(vae):
    _, _, m, s, a = vae
    with torch.no_grad():
        m.log_std.bias.fill_(-50.0)
        _, _, low = m(torch.from_numpy(s), torch.from_numpy(a), eps=torch.zeros(B, LATENT))
        m.log_std.bias.fill_(50.0)
        _, _, high = m(torch.from_numpy(s), torch.from_numpy(a), eps=torch.zeros(B, LATENT))
        m.load_state_dict(state_dict_from_jax_vae_params(vae[1]))
    np.testing.assert_allclose(low.numpy(), np.exp(-4.0), rtol=1e-6)
    np.testing.assert_allclose(high.numpy(), np.exp(15.0), rtol=1e-6)


def test_vae_policy_decode_and_decode_multiple_match_jax(vae):
    jm, params, m, s, _ = vae
    st = torch.from_numpy(s)
    k_dec, k_multi = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    eps = torch.from_numpy(np.array(jax.random.normal(k_dec, (B, LATENT))))
    z = np.random.RandomState(9).randn(B, LATENT).astype(np.float32)
    eps_multi = torch.from_numpy(np.array(jax.random.normal(k_multi, (B, 4, LATENT))))
    with torch.no_grad():
        prior = m.decode(st, eps=eps)
        given = m.decode(st, torch.from_numpy(z))
        multi, raw = m.decode_multiple(st, 4, eps=eps_multi)
        drawn = m.decode(st, generator=torch.Generator().manual_seed(0))
    dec = lambda *args: jm.apply(params, *args, method=JaxVAEPolicy.decode)  # noqa: E731
    np.testing.assert_allclose(prior.numpy(), np.asarray(dec(s, None, k_dec)), **TOL)
    np.testing.assert_allclose(given.numpy(), np.asarray(dec(s, z)), **TOL)
    ref_multi, ref_raw = jm.apply(params, s, k_multi, 4, method=JaxVAEPolicy.decode_multiple)
    assert multi.shape == (B, 4, ACT)
    np.testing.assert_allclose(multi.numpy(), np.asarray(ref_multi), **TOL)
    np.testing.assert_allclose(raw.numpy(), np.asarray(ref_raw), **TOL)
    assert drawn.shape == (B, ACT) and (drawn.abs() <= 2.0).all()


def test_policy_from_q_picks_the_argmax_q_proposal():
    policy = TanhGaussianPolicy(4, (8,), 2)
    agent = PolicyFromQ(lambda obs, a: a[:, :1], policy, num_samples=16, seed=3)
    obs = np.random.RandomState(10).randn(4).astype(np.float32)
    a, info = agent.get_action(obs)
    with torch.no_grad():
        proposals = policy(torch.from_numpy(obs)[None].expand(16, 4)).sample(
            torch.Generator().manual_seed(3))
    assert a.shape == (2,) and info == {}
    np.testing.assert_array_equal(a, proposals[proposals[:, 0].argmax()].numpy())
    assert a[0] == proposals[:, 0].max().item()
