"""The port's CQL trainer (s2p_tpu_torch.rl.cql) against the JAX package's.

One step on the SLAC path and three steps on the state path against JAX's
compiled ``_step`` and scanned ``_train_scan_state``: the same seeded
weights and batches, and JAX's draws computed from its keys and handed to
the port (``train(batch, draws=)``): posterior noise, the policy ε's, the
uniform random actions and the tiled ε's, JAX's ``split(key, 8)[0..5]``. Covered: both
policy input types, the Lagrange α′ off and on, ``min_q_version`` 3 and 2,
both sides of ``policy_eval_start`` (the BC warm-up with data actions at
exactly ±1) and the ``full_state`` round trip. f32 on the CPU, tiny widths.
Metrics 1e-5 relative; gradients through Adam's first moment (0.1 × the
gradient after one step; a policy-loss gradient that leaked into the critic
would show in the critic's) 1e-5 of each tensor's largest entry; weights
after the step 1e-6 but for at most 1e-4 of the entries, which may differ
by up to lr (``assert_trees_close``). The joint latent step after a SLAC
step is ``SlacAlgorithm.update_latent``, held to JAX in test_torch_iql.py;
here the latent is frozen and must not move."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from s2p_tpu.rl import CQLTrainer as JaxCQLTrainer
from s2p_tpu.rl import CriticSLAC as JaxCriticSLAC
from s2p_tpu.rl import TanhGaussianPolicy as JaxTanhGaussianPolicy
from s2p_tpu_torch.data.replay import SimpleReplayBuffer, SlacReplayBuffer
from s2p_tpu_torch.rl import (
    CQLTrainer,
    CriticSLAC,
    TanhGaussianPolicy,
    cql_full_state_from_jax,
    jax_cql_full_state,
    state_dict_from_jax_critic_params,
    state_dict_from_jax_policy_params,
)
from s2p_tpu_torch.slac.convert import jax_latent_params_from_state_dict
from tests.test_torch_iql import IQL_BATCH as B
from tests.test_torch_iql import OBS, _np, _seeded_init, assert_metrics, state_batch
from tests.test_torch_slac import (
    ACT,
    NS,
    assert_grads_close,
    assert_trees_close,
    dataset,
    jax_noise,
    make_jax_slac,
    make_port_slac,
)

HIDDEN, N_RANDOM = (32, 32), 3


def make_cql_pair(obs_dim, policy_input_dim, slac=None, seed=0, **kw):
    """(JAX trainer, port trainer) with the same seeded policy and critic."""
    kw = dict(num_random=N_RANDOM, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTanhGaussianPolicy, "init", _seeded_init(JaxTanhGaussianPolicy, seed))
        mp.setattr(JaxCriticSLAC, "init", _seeded_init(JaxCriticSLAC, seed + 1))
        jtr = JaxCQLTrainer(JaxTanhGaussianPolicy(HIDDEN, ACT), JaxCriticSLAC(HIDDEN), obs_dim,
                            policy_input_dim, ACT, slac_algo=slac[0] if slac else None, **kw)
    policy = TanhGaussianPolicy(policy_input_dim, HIDDEN, ACT)
    policy.load_state_dict(state_dict_from_jax_policy_params(_np(jtr.policy_state.params)))
    critic = CriticSLAC(obs_dim, ACT, HIDDEN)
    critic.load_state_dict(state_dict_from_jax_critic_params(_np(jtr.critic_state.params)))
    tr = CQLTrainer(policy, critic, slac_algo=slac[1] if slac else None, device="cpu", **kw)
    return jtr, tr


def jax_cql_draws(key, batch=B, slac=False):
    """The draws of ``CQLTrainer._step_body(..., key)``: ``split(key, 8)``,
    [0] posterior noise, [1] the policy ε, [2] the next-action ε, [3] the
    uniform actions, [4] and [5] the tiled ε's."""
    keys = jax.random.split(key, 8)
    normal = lambda k, n: np.array(jax.random.normal(k, (n, ACT)))  # noqa: E731
    d = dict(pi=normal(keys[1], batch), next=normal(keys[2], batch),
             random=np.array(jax.random.uniform(keys[3], (batch * N_RANDOM, ACT),
                                                minval=-1.0, maxval=1.0)),
             pi_tiled=normal(keys[4], batch * N_RANDOM),
             next_tiled=normal(keys[5], batch * N_RANDOM))
    if slac:
        d["posterior"] = jax_noise(keys[0], batch, NS + 1)
    return d


def jax_step(jtr, batch, step, key, use_slac=False):
    """One JAX step; the trainer's state advances, the metrics come back."""
    out = jtr._step(jtr.policy_state, jtr.critic_state, jtr.target_q, jtr.log_alpha,
                    jtr.alpha_opt_state, jtr.log_alpha_prime, jtr.alpha_prime_opt_state,
                    {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}, use_slac,
                    jnp.uint32(step), key, jtr.slac_algo.params if use_slac else None)
    (jtr.policy_state, jtr.critic_state, jtr.target_q, jtr.log_alpha, jtr.alpha_opt_state,
     jtr.log_alpha_prime, jtr.alpha_prime_opt_state) = out[:7]
    return dict(out[7])


def assert_same_state(jtr, tr):
    """Networks, temperatures and every Adam's first moment (the gradients)."""
    lr = tr.critic_opt.param_groups[0]["lr"]
    got = jax_cql_full_state(tr)
    for name, ref in (("policy_params", jtr.policy_state.params),
                      ("critic_params", jtr.critic_state.params), ("target_q", jtr.target_q)):
        assert_trees_close(got[name], ref, lr=lr)
    for name in ("log_alpha", "log_alpha_prime"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(jtr, name)), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for name, ref in (("policy_opt", jtr.policy_state.opt_state),
                      ("critic_opt", jtr.critic_state.opt_state),
                      ("alpha_opt", jtr.alpha_opt_state),
                      ("alpha_prime_opt", jtr.alpha_prime_opt_state)):
        assert got[name]["count"] == int(ref[0].count), name
        assert_grads_close(got[name]["mu"], _np(ref[0].mu))


SLAC_CASES = [  # (input type, Lagrange, min_q_version, policy_eval_start)
    ("feature_action", False, 3, 40_000),
    ("latent_z", True, 2, 0),
]


@pytest.mark.parametrize("input_type,lagrange,version,eval_start", SLAC_CASES)
def test_slac_step_matches_jax(input_type, lagrange, version, eval_start):
    """prepare_batch → α → policy (BC warm-up with actions at ±1, or SAC
    through the pre-update critic) → critic with the CQL penalty from the
    updated policy → α′ → targets."""
    jslac = make_jax_slac()
    slac = make_port_slac(jslac)
    ds = dataset(seed=1)
    jslac.buffer.ingest_real(ds)
    slac.buffer.ingest_real(ds)
    pin = slac.feature_action_dim if input_type == "feature_action" else slac.z_dim
    jtr, tr = make_cql_pair(slac.z_dim, pin, (jslac, slac), slac_policy_input_type=input_type,
                            with_lagrange=lagrange, lagrange_thresh=2.0, min_q_version=version,
                            policy_eval_start=eval_start, freeze_slac=True)
    obs, act, rew, done = slac.buffer.gather(torch.tensor([1, 4, 7, 2]))
    act[:, -1, 0], act[0, -1, 1] = 1.0, -1.0  # data actions on the clip of atanh
    batch = dict(observations=obs, actions=act, rewards=rew[:, -1] + torch.arange(4.0)[:, None],
                 terminals=done[:, -1])
    key = jax.random.PRNGKey(21)
    ref = jax_step(jtr, batch, 0, key, use_slac=True)
    got = tr.train(batch, draws=jax_cql_draws(key, slac=True))
    assert ("alpha_prime" in got) == lagrange
    assert_metrics(got, ref)
    assert_same_state(jtr, tr)
    after = jax_latent_params_from_state_dict(slac.latent.state_dict())["params"]
    assert_trees_close(after, jslac.params["params"], atol=0.0)


STATE_CASES = [  # (Lagrange, min_q_version, policy_eval_start, deterministic backup)
    (False, 3, 1, False),
    (True, 2, 0, True),
]


@pytest.mark.parametrize("lagrange,version,eval_start,det_backup", STATE_CASES)
def test_state_path_three_steps_match_jax_scan(lagrange, version, eval_start, det_backup):
    """JAX's scanned ``train_many`` over three steps (batches and draws from
    its keys) against the port's ``train`` with those batches and draws;
    target period 2; with ``policy_eval_start`` 1 the warm-up runs at step
    0 and SAC's loss after it."""
    kw = dict(with_lagrange=lagrange, lagrange_thresh=-3.0, min_q_version=version,
              policy_eval_start=eval_start, deterministic_backup=det_backup,
              target_update_period=2, use_automatic_entropy_tuning=not det_backup)
    jtr, tr = make_cql_pair(OBS, OBS, **kw)
    rows = {k: np.concatenate([state_batch(i)[k] for i in range(5)]) for k in state_batch(0)}
    state = dict({k: jnp.asarray(v) for k, v in rows.items()}, n=jnp.int32(len(rows["rewards"])))
    key, steps = jax.random.PRNGKey(40), 3
    carry0 = (jtr.policy_state, jtr.critic_state, jtr.target_q, jtr.log_alpha,
              jtr.alpha_opt_state, jtr.log_alpha_prime, jtr.alpha_prime_opt_state)
    carry, ref = jtr._train_scan_state(carry0, steps, B, state, jnp.uint32(0), key)
    (jtr.policy_state, jtr.critic_state, jtr.target_q, jtr.log_alpha, jtr.alpha_opt_state,
     jtr.log_alpha_prime, jtr.alpha_prime_opt_state) = carry
    for k_i in jax.random.split(key, steps):
        k_batch, k_step = jax.random.split(k_i)
        idx = np.asarray(jax.random.randint(k_batch, (B,), 0, state["n"]))
        got = tr.train({k: v[idx] for k, v in rows.items()}, draws=jax_cql_draws(k_step))
    assert_metrics(got, ref)
    assert_same_state(jtr, tr)
    assert tr.get_diagnostics()["num train calls"] == steps


def test_full_state_round_trips_with_jax():
    """JAX's full_state (both temperatures, every optax moment and count)
    carried into the port continues the same run; the port's state goes
    back out in JAX's layout."""
    jtr, tr = make_cql_pair(OBS, OBS, with_lagrange=True, policy_eval_start=0)
    jax_step(jtr, state_batch(0), 0, jax.random.PRNGKey(50))
    jtr._n_train_steps_total = 1
    tr.load_full_state(cql_full_state_from_jax(tr, _np(jtr.full_state())))
    assert tr._n_train_steps_total == 1
    key = jax.random.PRNGKey(51)
    ref = jax_step(jtr, state_batch(1), 1, key)
    assert_metrics(tr.train(state_batch(1), draws=jax_cql_draws(key)), ref)
    assert_same_state(jtr, tr)
    out = jax_cql_full_state(tr)
    assert out["policy_step"] == out["critic_step"] == int(jtr.policy_state.step) == 2
    assert out["alpha_prime_opt"]["count"] == 2
    for name in ("alpha_opt", "alpha_prime_opt"):
        for moment in ("mu", "nu"):
            ref = getattr(getattr(jtr, name + "_state")[0], moment)
            np.testing.assert_allclose(out[name][moment], np.asarray(ref), rtol=1e-5, atol=1e-12,
                                       err_msg=f"{name} {moment}")
    rebuilt = (optax.ScaleByAdamState(count=jnp.int32(2), mu=out["alpha_opt"]["mu"],
                                      nu=out["alpha_opt"]["nu"]), optax.EmptyState())
    assert (jax.tree_util.tree_structure(rebuilt)
            == jax.tree_util.tree_structure(jtr.alpha_opt_state))
    back = dict(tr.full_state())
    tr.train(state_batch(2))
    tr.load_full_state(back)
    assert tr._n_train_steps_total == 2 and tr.log_alpha.item() == float(back["log_alpha"])


def test_train_many_slac_and_state_paths():
    """Batches and every draw from the trainer's generator on the device
    (half of each batch from the generated buffer when one is given), the
    joint latent step each step, statistics read once."""
    jslac = make_jax_slac()
    slac = make_port_slac(jslac)
    slac.buffer.ingest_real(dataset(seed=2))
    gen = SlacReplayBuffer(300, NS, (64, 64, 3), ACT, device="cpu")
    gen.ingest_real(dataset(seed=3))
    policy = TanhGaussianPolicy(slac.feature_action_dim, HIDDEN, ACT)
    tr = CQLTrainer(policy, CriticSLAC(slac.z_dim, ACT, HIDDEN), slac_algo=slac,
                    num_random=N_RANDOM, policy_eval_start=1, with_lagrange=True, device="cpu")
    before = {k: v.clone() for k, v in slac.latent.state_dict().items()}
    p_before, q_before = policy.fc0.weight.clone(), tr.critic.qf1.fc0.weight.clone()
    metrics = tr.train_many(3, 6, buffer_gen=gen)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert {"loss_kld", "std_q1", "alpha_prime", "min_qf1_loss"} <= set(tr.eval_statistics)
    assert slac.learning_steps_latent == 3 and tr._n_train_steps_total == 3
    assert not torch.equal(policy.fc0.weight, p_before)
    assert not torch.equal(tr.critic.qf1.fc0.weight, q_before)
    assert tr.log_alpha_prime.item() != 0.0
    assert any(not torch.equal(v, before[k]) for k, v in slac.latent.state_dict().items())
    assert sorted(tr.get_snapshot()) == ["critic_params", "latent_params", "log_alpha",
                                         "policy_params", "target_q"]

    buf = SimpleReplayBuffer(100, OBS, ACT, device="cpu")
    rs = np.random.RandomState(4)
    for _ in range(20):
        buf.add_sample(rs.randn(OBS), rs.uniform(-1, 1, ACT), rs.randn(), 0.0, rs.randn(OBS))
    st = CQLTrainer(TanhGaussianPolicy(OBS, HIDDEN, ACT), CriticSLAC(OBS, ACT, HIDDEN),
                    num_random=N_RANDOM, device="cpu")
    out = st.train_many(4, 8, buffer=buf)
    assert all(torch.isfinite(v) for v in out.values()) and st._n_train_steps_total == 4
    with pytest.raises(ValueError):
        st.train_many(1, 8)
