"""The port's IQL trainer, policies and critics (s2p_tpu_torch.rl) against
the JAX package's.

One ``train()`` step of the port against JAX's compiled ``_step`` and, with
an unfrozen latent, ``_latent_step`` after it: the same seeded weights, the
same window batch, and JAX's posterior noise and window indices handed to
the port (``prepare_noise``, ``latent_draws``). f32 on the CPU; metrics
1e-5 relative, parameters after the Adam step 1e-6 absolute (lr is 1e-4 to
3e-4, so a wrong or missing update shows), but for at most 1e-4 of the
entries, which may differ by up to lr (``assert_trees_close``)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from s2p_tpu.rl import CriticSLAC as JaxCriticSLAC
from s2p_tpu.rl import GaussianPolicy as JaxGaussianPolicy
from s2p_tpu.rl import IQLTrainer as JaxIQLTrainer
from s2p_tpu.rl import TanhGaussianPolicy as JaxTanhGaussianPolicy
from s2p_tpu.rl import soft_update as jax_soft_update
from s2p_tpu_torch.data.replay import SimpleReplayBuffer, SlacReplayBuffer
from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict
from s2p_tpu_torch.rl import (
    CriticSLAC,
    GaussianPolicy,
    IQLTrainer,
    TanhGaussianPolicy,
    iql_full_state_from_jax,
    jax_iql_full_state,
    make_deterministic,
    soft_update,
    state_dict_from_jax_critic_params,
    state_dict_from_jax_policy_params,
)
from s2p_tpu_torch.slac.convert import jax_latent_params_from_state_dict
from tests.test_torch_generator import seeded_params
from tests.test_torch_slac import (
    ACT,
    NS,
    assert_trees_close,
    dataset,
    jax_latent_draws,
    jax_noise,
    make_jax_slac,
    make_port_slac,
)

HIDDEN, IQL_BATCH, OBS = (32, 32), 4, 6
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _seeded_init(cls, seed):
    orig = cls.init

    def init(self, rng, *args):
        return {"params": seeded_params(functools.partial(orig, self), *args, seed=seed)}

    return init


def make_pair(obs_dim, policy_input_dim, slac=None, seed=0, **kw):
    """(JAX trainer, port trainer) with the same seeded policy and critic."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTanhGaussianPolicy, "init", _seeded_init(JaxTanhGaussianPolicy, seed))
        mp.setattr(JaxCriticSLAC, "init", _seeded_init(JaxCriticSLAC, seed + 1))
        jtr = JaxIQLTrainer(JaxTanhGaussianPolicy(HIDDEN, ACT), JaxCriticSLAC(HIDDEN), obs_dim,
                            policy_input_dim, ACT, slac_algo=slac[0] if slac else None, **kw)
    policy = TanhGaussianPolicy(policy_input_dim, HIDDEN, ACT)
    policy.load_state_dict(state_dict_from_jax_policy_params(_np(jtr.policy_state.params)))
    critic = CriticSLAC(obs_dim, ACT, HIDDEN)
    critic.load_state_dict(state_dict_from_jax_critic_params(_np(jtr.critic_state.params)))
    tr = IQLTrainer(policy, critic, slac_algo=slac[1] if slac else None, device="cpu", **kw)
    return jtr, tr


def assert_same_networks(jtr, tr):
    lr = tr.critic_opt.param_groups[0]["lr"]
    assert_trees_close(jax_dense_tree_from_state_dict(tr.policy.state_dict()),
                       jtr.policy_state.params, lr=lr)
    assert_trees_close(jax_dense_tree_from_state_dict(tr.critic.state_dict()),
                       jtr.critic_state.params, lr=lr)
    assert_trees_close(jax_dense_tree_from_state_dict(tr.target_q.state_dict())["params"],
                       jtr.target_q, lr=lr)


def assert_metrics(got, ref):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(got[k]), float(r), err_msg=k, **METRIC_TOL)


@pytest.mark.parametrize("input_type,freeze", [("feature_action", False), ("latent_z", True)])
def test_slac_train_step_matches_jax(input_type, freeze):
    """prepare_batch → critic and AWR losses → both Adams → target update
    from the updated critic (step 0) → the joint latent step on the
    pre-update latent."""
    jslac = make_jax_slac()
    slac = make_port_slac(jslac)
    ds = dataset(seed=1)
    jslac.buffer.ingest_real(ds)
    slac.buffer.ingest_real(ds)
    pin = slac.feature_action_dim if input_type == "feature_action" else slac.z_dim
    jtr, tr = make_pair(slac.z_dim, pin, (jslac, slac), slac_policy_input_type=input_type,
                        freeze_slac=freeze)
    obs, act, rew, done = slac.buffer.gather(torch.tensor([1, 4, 7, 2]))
    rew, done = rew + torch.arange(4.0)[:, None, None], done
    batch = dict(observations=obs, actions=act, rewards=rew[:, -1], terminals=done[:, -1])
    k_prep, k_lat = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    p_state, c_state, target, ref = jtr._step(jtr.policy_state, jtr.critic_state, jtr.target_q,
                                              jbatch, jnp.uint32(0), True, jslac.params, k_prep)
    ref = dict(ref)
    latent_ref = jslac.params
    if not freeze:
        latent_ref, _, aux = jslac._latent_step(jslac.params, jslac.opt_state,
                                                jslac.batch_size_latent,
                                                jslac.buffer.device_state(), k_lat)
        ref.update(loss_kld=aux[0], loss_image=aux[1], loss_reward=aux[2])
    before = jax_latent_params_from_state_dict(slac.latent.state_dict())["params"]
    got = tr.train(batch, prepare_noise=jax_noise(k_prep, IQL_BATCH, NS + 1),
                   latent_draws=jax_latent_draws(k_lat, len(slac.buffer), slac.batch_size_latent))
    assert_metrics(got, ref)
    assert sorted(tr.eval_statistics) == sorted(ref)
    jtr.policy_state, jtr.critic_state, jtr.target_q = p_state, c_state, target
    assert_same_networks(jtr, tr)
    after = jax_latent_params_from_state_dict(slac.latent.state_dict())["params"]
    assert_trees_close(after, latent_ref["params"], lr=slac.lr_latent)
    moved = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: bool(np.any(a != b)), after, before))
    assert any(moved) != freeze


def state_batch(seed):
    rs = np.random.RandomState(seed)
    return dict(observations=rs.randn(IQL_BATCH, OBS).astype(np.float32),
                next_observations=rs.randn(IQL_BATCH, OBS).astype(np.float32),
                actions=rs.uniform(-0.9, 0.9, (IQL_BATCH, ACT)).astype(np.float32),
                rewards=rs.randn(IQL_BATCH, 1).astype(np.float32),
                terminals=(rs.rand(IQL_BATCH, 1) < 0.3).astype(np.float32))


@pytest.mark.parametrize("periods", [(2, 1, 1), (1, 2, 3)])
def test_state_path_update_cadence_over_three_steps(periods):
    """Targets move at steps where step % target_update_period == 0 (step 0
    included), the policy and the critic at their own periods."""
    target_p, policy_p, q_p = periods
    jtr, tr = make_pair(OBS, OBS, target_update_period=target_p,
                        policy_update_period=policy_p, q_update_period=q_p,
                        reward_transform=(2.0, 0.5))
    step = jax.jit(functools.partial(jtr._step_body, use_slac=False))
    for i in range(3):
        batch = state_batch(i)
        targets_before = {k: v.clone() for k, v in tr.target_q.state_dict().items()}
        jtr.policy_state, jtr.critic_state, jtr.target_q, ref = step(
            jtr.policy_state, jtr.critic_state, jtr.target_q, batch, jnp.uint32(i))
        got = tr.train({k: torch.from_numpy(v) for k, v in batch.items()})
        assert_metrics(got, ref)
        assert_same_networks(jtr, tr)
        moved = any(not torch.equal(v, targets_before[k])
                    for k, v in tr.target_q.state_dict().items())
        assert moved == (i % target_p == 0), i
    assert tr.get_diagnostics()["num train calls"] == 3


def test_full_state_round_trips_with_jax():
    """JAX's full_state (optax moments and counts included) carried into
    the port continues the same run; the port's state goes back out."""
    jtr, tr = make_pair(OBS, OBS)
    step = jax.jit(functools.partial(jtr._step_body, use_slac=False))
    jtr.policy_state, jtr.critic_state, jtr.target_q, _ = step(
        jtr.policy_state, jtr.critic_state, jtr.target_q, state_batch(0), jnp.uint32(0))
    jtr._n_train_steps_total = 1
    tr.load_full_state(iql_full_state_from_jax(tr, _np(jtr.full_state())))
    assert tr._n_train_steps_total == 1
    jtr.policy_state, jtr.critic_state, jtr.target_q, ref = step(
        jtr.policy_state, jtr.critic_state, jtr.target_q, state_batch(1), jnp.uint32(1))
    assert_metrics(tr.train({k: torch.from_numpy(v) for k, v in state_batch(1).items()}), ref)
    assert_same_networks(jtr, tr)
    out = jax_iql_full_state(tr)
    for name, opt_state in (("policy", jtr.policy_state.opt_state),
                            ("critic", jtr.critic_state.opt_state)):
        adam = opt_state[0]
        assert out[f"{name}_opt"]["count"] == int(adam.count) == 2
        for moment in ("mu", "nu"):  # gradients' f32 noise: 1e-5 relative
            jax.tree_util.tree_map(
                lambda g, r: np.testing.assert_allclose(g, np.asarray(r), rtol=1e-5, atol=1e-7),
                out[f"{name}_opt"][moment], _np(getattr(adam, moment)))
    assert_trees_close(out["target_q"], jtr.target_q)
    rebuilt = (optax.ScaleByAdamState(count=jnp.int32(2), mu=out["policy_opt"]["mu"],
                                      nu=out["policy_opt"]["nu"]), optax.EmptyState())
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_structure(rebuilt),
                           jax.tree_util.tree_structure(jtr.policy_state.opt_state))


def test_policies_and_critic_match_jax():
    rs = np.random.RandomState(3)
    x, a = rs.randn(5, OBS).astype(np.float32), rs.uniform(-1, 1, (5, ACT)).astype(np.float32)
    for jcls, cls in ((JaxTanhGaussianPolicy, TanhGaussianPolicy),
                      (JaxGaussianPolicy, GaussianPolicy)):
        jm = jcls(HIDDEN, ACT)
        params = seeded_params(jm.init, jnp.zeros((1, OBS)), seed=4)
        m = cls(OBS, HIDDEN, ACT)
        m.load_state_dict(state_dict_from_jax_policy_params(params), strict=True)
        ref = jm.apply({"params": params}, x)
        with torch.no_grad():
            dist = m(torch.from_numpy(x))
            np.testing.assert_allclose(dist.loc.numpy(), np.asarray(ref.loc), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(dist.scale.numpy(), np.asarray(ref.scale), rtol=1e-5)
            np.testing.assert_allclose(dist.log_prob(torch.from_numpy(a)).numpy(),
                                       np.asarray(ref.log_prob(a)), rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(make_deterministic(dist).mode.numpy(),
                                          dist.mode.numpy())
    jc = JaxCriticSLAC(HIDDEN)
    params = seeded_params(jc.init, jnp.zeros((1, OBS)), jnp.zeros((1, ACT)), seed=5)
    c = CriticSLAC(OBS, ACT, HIDDEN)
    c.load_state_dict(state_dict_from_jax_critic_params(params), strict=True)
    with torch.no_grad():
        got = c(torch.from_numpy(x), torch.from_numpy(a))
    for g, r in zip(got, jc.apply({"params": params}, x, a)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    c2 = CriticSLAC(OBS, ACT, HIDDEN, seed=9)
    p2 = jax_dense_tree_from_state_dict(c2.state_dict())["params"]
    ref = jax_soft_update(params, p2, 0.3)
    soft_update(c, c2, 0.3)
    assert_trees_close(jax_dense_tree_from_state_dict(c.state_dict())["params"], ref, atol=1e-7)


def test_train_many_slac_and_state_paths():
    """Batches drawn on the device (half from the generated buffer when one
    is given), the joint latent step each step, statistics read once."""
    jslac = make_jax_slac()
    slac = make_port_slac(jslac)
    slac.buffer.ingest_real(dataset(seed=2))
    gen = SlacReplayBuffer(300, NS, (64, 64, 3), ACT, device="cpu")
    gen.ingest_real(dataset(seed=3))
    policy = TanhGaussianPolicy(slac.feature_action_dim, HIDDEN, ACT)
    tr = IQLTrainer(policy, CriticSLAC(slac.z_dim, ACT, HIDDEN), slac_algo=slac, device="cpu")
    before = {k: v.clone() for k, v in slac.latent.state_dict().items()}
    p_before = policy.fc0.weight.clone()
    metrics = tr.train_many(3, 6, buffer_gen=gen)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert {"loss_kld", "loss_image", "critic_loss", "awr_weights"} <= set(tr.eval_statistics)
    assert slac.learning_steps_latent == 3 and tr._n_train_steps_total == 3
    assert not torch.equal(policy.fc0.weight, p_before)
    assert any(not torch.equal(v, before[k]) for k, v in slac.latent.state_dict().items())
    tr.end_epoch(0)
    snap = tr.get_snapshot()
    assert sorted(snap) == ["critic_params", "latent_params", "policy_params", "target_q"]

    buf = SimpleReplayBuffer(100, OBS, ACT, device="cpu")
    rs = np.random.RandomState(4)
    for _ in range(20):
        buf.add_sample(rs.randn(OBS), rs.uniform(-1, 1, ACT), rs.randn(), 0.0, rs.randn(OBS))
    st = IQLTrainer(TanhGaussianPolicy(OBS, HIDDEN, ACT), CriticSLAC(OBS, ACT, HIDDEN),
                    device="cpu")
    out = st.train_many(4, 8, buffer=buf)
    assert all(torch.isfinite(v) for v in out.values()) and st._n_train_steps_total == 4
    with pytest.raises(ValueError):
        st.train_many(1, 8)
