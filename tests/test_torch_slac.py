"""The port's SLAC (s2p_tpu_torch.slac) against the JAX package's.

Both packages get the same seeded numpy weights (a flax ``params`` tree
from ``jax.eval_shape``, carried in by ``state_dict_from_jax_latent_params``)
and the same window indices and posterior noise: JAX draws them from split
PRNG keys, which the port cannot reproduce, so the test computes them from
the key and hands them to the port. Tiny widths, 64px and 100px, f32 on the
CPU. Tolerances: 1e-5 relative on features, losses and outputs; gradients
1e-5 of each tensor's largest entry (the image NLL sums ~10⁵ f32 terms in
another order on each side)."""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.data.hdf5 import make_synthetic_rl_dataset
from s2p_tpu.slac import LatentModel as JaxLatentModel
from s2p_tpu.slac import SlacAlgorithm as JaxSlacAlgorithm
from s2p_tpu.slac import calculate_kl_divergence as jax_kl
from s2p_tpu.slac import convert_latent_state_dict as jax_convert_latent_state_dict
from s2p_tpu.slac import create_feature_actions as jax_feature_actions
from s2p_tpu_torch.slac import (
    LatentModel,
    SlacAlgorithm,
    calculate_kl_divergence,
    convert_latent_state_dict,
    create_feature_actions,
    jax_latent_params_from_state_dict,
    state_dict_from_jax_latent_params,
)
from tests.test_torch_generator import seeded_params

ACT, NS, BATCH = 3, 3, 2
SMALL = dict(feature_dim=16, z1_dim=4, z2_dim=8, hidden_units=(16, 16))
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def jax_latent_params(image_size: int = 64, seed: int = 0):
    lm = JaxLatentModel(action_dim=ACT, image_size=image_size, **SMALL)
    obs = jnp.zeros((1, NS + 1, image_size, image_size, 3))
    act, rew = jnp.zeros((1, NS, ACT)), jnp.zeros((1, NS, 1))
    return lm, seeded_params(lm.init, obs, act, rew, rew, jax.random.PRNGKey(0), seed=seed)


def port_latent(params, image_size: int = 64) -> LatentModel:
    m = LatentModel(ACT, image_size=image_size, **SMALL)
    m.load_state_dict(state_dict_from_jax_latent_params(params), strict=True)
    return m


def jax_noise(key, batch: int, steps: int, z1: int = SMALL["z1_dim"], z2: int = SMALL["z2_dim"]):
    """The standard normals of ``LatentModel.sample_posterior(..., key)``
    in its order: z1 then z2 at each of ``steps`` steps, each from
    ``rng, k = split(rng)``."""
    out, rng = [], key
    for _ in range(steps):
        for dim in (z1, z2):
            rng, k = jax.random.split(rng)
            out.append(_t(jax.random.normal(k, (batch, dim))))
    return out


def jax_latent_draws(key, n: int, batch: int):
    """The slot indices and posterior noise of ``SlacAlgorithm._latent_step``."""
    k_idx, k_noise = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_idx, (batch,), 0, n))
    return torch.from_numpy(idx.astype(np.int64)), jax_noise(k_noise, batch, NS + 1)


def make_jax_slac(image_size: int = 64, batch_size_latent: int = BATCH, **kw):
    """A JAX SlacAlgorithm whose latent params are the seeded ones (flax's
    own ``init`` takes ~20 s on the CPU)."""
    orig = JaxLatentModel.init

    def fast_init(self, rng, *args):
        return {"params": seeded_params(functools.partial(orig, self), *args)}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxLatentModel, "init", fast_init)
        return JaxSlacAlgorithm(action_dim=ACT, num_sequences=NS, buffer_size=300,
                                batch_size_latent=batch_size_latent, image_size=image_size,
                                seed=0, **dict(SMALL, **kw))


def make_port_slac(jslac, **kw) -> SlacAlgorithm:
    algo = SlacAlgorithm(ACT, num_sequences=NS, buffer_size=300,
                         batch_size_latent=jslac.batch_size_latent, image_size=jslac.image_size,
                         device="cpu", **SMALL, **kw)
    algo.latent.load_state_dict(state_dict_from_jax_latent_params(jslac.params), strict=True)
    return algo


def dataset(image_size: int = 64, seed: int = 0):
    return make_synthetic_rl_dataset(2, 12, act_dim=ACT, img_hw=image_size, seed=seed)


@pytest.fixture(scope="module")
def slacs():
    jslac = make_jax_slac()
    algo = make_port_slac(jslac)
    ds = dataset()
    assert jslac.buffer.ingest_real(ds) == algo.buffer.ingest_real(ds) > 0
    return jslac, algo


def window_batch(seed: int = 0, image_size: int = 64):
    rs = np.random.RandomState(seed)
    obs = rs.rand(BATCH, NS + 1, image_size, image_size, 3).astype(np.float32)
    act = rs.uniform(-1, 1, (BATCH, NS, ACT)).astype(np.float32)
    rew = rs.randn(BATCH, NS, 1).astype(np.float32)
    done = (rs.rand(BATCH, NS, 1) < 0.3).astype(np.float32)
    return obs, act, rew, done


def assert_trees_close(got, ref, atol=1e-6, lr=0.0):
    """Leaf by leaf within ``atol``; after an Adam step with learning rate
    ``lr``, up to 1e-4 of the entries may differ by up to ``lr``: Adam's
    first update is lr·g/(|g| + 1e-8), so a gradient within f32 noise of
    zero moves its weight by an amount that noise decides."""
    def check(g, r):
        err = np.abs(np.asarray(g, np.float64) - np.asarray(r, np.float64))
        off = err > atol
        assert off.mean() <= (1e-4 if lr else 0.0) and (err[off] <= lr).all(), (
            f"{off.sum()} of {err.size} entries off by up to {err.max():.3g}")

    jax.tree_util.tree_map(check, got, jax.device_get(ref))


def assert_grads_close(got_tree, ref_tree, rel=1e-5):
    def check(g, r):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * max(np.abs(r).max(), 1e-12))

    jax.tree_util.tree_map(check, got_tree, ref_tree)


@pytest.mark.parametrize("image_size", [64, 100])
def test_encoder_and_decoder_match_jax(image_size):
    lm, params = jax_latent_params(image_size)
    m = port_latent(params, image_size)
    obs, _, _, _ = window_batch(image_size=image_size)
    obs = obs[:1, :2]
    feats = jax.jit(lambda p, o: lm.apply({"params": p}, o, method=JaxLatentModel.encode))
    ref = np.asarray(feats(params, obs))
    z = np.random.RandomState(1).randn(1, 2, 12).astype(np.float32)
    dec = jax.jit(lambda p, z: lm.apply({"params": p}, z, method=lambda mod, z: mod.decoder(z)))
    ref_mean, ref_std = (np.asarray(v) for v in dec(params, z))
    with torch.no_grad():
        got = m.encode(_t(obs)).numpy()
        mean, std = m.decoder(_t(z))
    assert got.shape == ref.shape == (1, 2, SMALL["feature_dim"])
    np.testing.assert_allclose(got, ref, **TOL)
    assert mean.shape == ref_mean.shape == (1, 2, image_size, image_size, 3)
    np.testing.assert_allclose(mean.numpy(), ref_mean, **TOL)
    np.testing.assert_allclose(std.numpy(), ref_std, **TOL)


def test_kl_and_feature_actions_match_jax():
    rs = np.random.RandomState(2)
    pm, ps, qm, qs = (rs.rand(3, 5).astype(np.float32) + 0.1 for _ in range(4))
    np.testing.assert_allclose(calculate_kl_divergence(_t(pm), _t(ps), _t(qm), _t(qs)).numpy(),
                               np.asarray(jax_kl(pm, ps, qm, qs)), **TOL)
    f, a = rs.randn(2, NS + 1, 4).astype(np.float32), rs.randn(2, NS, ACT).astype(np.float32)
    for got, ref in zip(create_feature_actions(_t(f), _t(a)), jax_feature_actions(f, a)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_compute_loss_and_gradients_match_jax():
    """The three ELBO terms and every latent gradient, with JAX's noise."""
    lm, params = jax_latent_params(64)
    m = port_latent(params)
    obs, act, rew, done = window_batch()
    key = jax.random.PRNGKey(3)

    def total(p):
        kld, img, r = lm.apply({"params": p}, obs, act, rew, done, key)
        return kld + img + r, (kld, img, r)

    (_, terms), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    got = m.compute_loss(_t(obs), _t(act), _t(rew), _t(done), jax_noise(key, BATCH, NS + 1))
    sum(got).backward()
    for g, r in zip(got, terms):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-5)
    assert float(terms[2]) != 0.0  # the reward term is masked, not zero
    port_grads = {n: p.grad for n, p in m.named_parameters()}
    assert_grads_close(jax_latent_params_from_state_dict(port_grads)["params"], grads)


def test_latent_z_and_prepare_batch_match_jax(slacs):
    jslac, algo = slacs
    obs, act, _, _ = window_batch(seed=4)
    key = jax.random.PRNGKey(4)
    ref = jslac._prepare(jslac.params, jnp.asarray(obs), jnp.asarray(act), key)
    got = algo.prepare_batch(_t(obs), _t(act), jax_noise(key, BATCH, NS + 1))
    names = ("z", "next_z", "action", "feature_action", "next_feature_action")
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape, name
        assert not g.requires_grad, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_one_latent_step_with_adam_matches_jax(slacs):
    """Gather at JAX's indices → ELBO → Adam: losses, gradients and the
    updated parameters."""
    jslac, algo = slacs
    algo = make_port_slac(jslac)
    algo.buffer = slacs[1].buffer
    key = jax.random.PRNGKey(5)
    new_params, _, aux = jslac._latent_step(jslac.params, jslac.opt_state, BATCH,
                                            jslac.buffer.device_state(), key)
    idx, noise = jax_latent_draws(key, len(jslac.buffer), BATCH)
    losses = algo.update_latent(idx=idx, noise=noise)
    for k, r in zip(("loss_kld", "loss_image", "loss_reward"), aux):
        np.testing.assert_allclose(losses[k].item(), float(r), rtol=1e-5, err_msg=k)
    assert algo.learning_steps_latent == 1
    got = jax_latent_params_from_state_dict(algo.latent.state_dict())["params"]
    assert_trees_close(got, new_params["params"], lr=algo.lr_latent)


def test_reference_state_dict_loads_strict_with_shared_aliases():
    """A reference ``latent.pth`` state dict (every head under its own name,
    ``z2_posterior*`` as copies) loads with ``strict=True``; the aliases are
    the ``z2_prior*`` modules; JAX's converter reads the same weights."""
    m = LatentModel(ACT, image_size=64, **SMALL)
    assert m.z2_posterior is m.z2_prior and m.z2_posterior_init is m.z2_prior_init
    rs = np.random.RandomState(6)
    ref = {k: rs.randn(*v.shape).astype(np.float32) for k, v in m.state_dict().items()}
    for alias, target in (("z2_posterior_init", "z2_prior_init"), ("z2_posterior", "z2_prior")):
        for k in [k for k in ref if k.startswith(target + ".")]:
            ref[alias + k[len(target):]] = ref[k]
    fresh = LatentModel(ACT, image_size=64, **SMALL, seed=1)
    fresh.load_state_dict(convert_latent_state_dict(ref), strict=True)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    # a file without the aliases and with z1_prior_init entries loads too
    partial = {k: v for k, v in ref.items() if not k.startswith("z2_posterior")}
    partial["z1_prior_init.dummy"] = np.zeros(1, np.float32)
    fresh.load_state_dict(convert_latent_state_dict(partial), strict=True)
    jax_tree = jax.device_get(jax_convert_latent_state_dict(ref))["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax_latent_params_from_state_dict(fresh.state_dict())["params"],
                           jax_tree)
    back = state_dict_from_jax_latent_params(jax_tree)
    assert sorted(back) == sorted(m.state_dict())


def test_save_model_loads_in_jax_and_gives_the_same_features(slacs, tmp_path):
    jslac, algo = slacs
    algo.save_model(str(tmp_path))
    with open(tmp_path / "encoder.pkl", "rb") as f:
        enc = pickle.load(f)
    assert sorted(enc["params"]) == [f"conv{i}" for i in range(5)]
    other = make_jax_slac()
    other.load_latent(str(tmp_path / "latent.pkl"))
    obs, _, _, _ = window_batch(seed=7)
    ref = other.latent.apply(other.params, jnp.asarray(obs), method=JaxLatentModel.encode)
    with torch.no_grad():
        got = algo.latent.encode(_t(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    frames = (obs[0] * 255).astype(np.uint8)
    acts = np.random.RandomState(8).randn(NS - 1, ACT).astype(np.float32)
    np.testing.assert_allclose(algo.preprocess(frames, acts).numpy(),
                               np.asarray(other.preprocess(frames, acts)), **TOL)


def test_load_latent_reads_pth_and_refuses_a_jax_pickle(slacs, tmp_path):
    jslac, algo = slacs
    ref = {k: v.numpy() for k, v in algo.latent.state_dict().items()}
    torch.save({k: torch.from_numpy(v) for k, v in ref.items()}, tmp_path / "latent.pth")
    other = make_port_slac(jslac, seed=9)
    other.opt.step()  # a stale optimizer must not survive the load
    other.load_latent(str(tmp_path / "latent.pth"))
    for k, v in other.latent.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k])
    assert not other.opt.state_dict()["state"]
    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump({"params": {"x": jnp.zeros(2)}}, f)
    with pytest.raises(ValueError, match="numpy leaves"):
        other.load_latent(str(tmp_path / "bad.pkl"))
    assert os.path.exists(tmp_path / "latent.pth")


def test_generator_draws_are_seeded_and_in_noise_order(slacs):
    """Without given noise the posterior draws from the algorithm's
    generator, z1 then z2 per step, the same list ``posterior_noise``
    gives."""
    _, algo = slacs
    obs, act, _, _ = window_batch(seed=10)
    algo.generator.manual_seed(11)
    a = algo.prepare_batch(_t(obs), _t(act))
    algo.generator.manual_seed(11)
    noise = algo.latent.posterior_noise(BATCH, NS + 1, algo.generator, _t(obs))
    b = algo.prepare_batch(_t(obs), _t(act), noise)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert [n.shape[1] for n in noise[:2]] == [SMALL["z1_dim"], SMALL["z2_dim"]]
    c = algo.prepare_batch(_t(obs), _t(act))
    assert not torch.equal(a[0], c[0])
