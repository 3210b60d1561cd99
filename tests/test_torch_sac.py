"""The port's SAC trainer (s2p_tpu_torch.rl.sac) and SLAC's online networks
(s2p_tpu_torch.slac.networks) against the JAX package's.

The same seeded numpy weights go into both packages; JAX draws its ε from
split keys, so the test computes them from the key and hands them to the
port (``train(batch, draws=)``). f32 on the CPU, tiny widths. Metrics 1e-5
relative; gradients through Adam's first moment (0.1 × the gradient after
one step) 1e-5 of each tensor's largest entry; weights after the step 1e-6
but for at most 1e-4 of the entries, which may differ by up to lr
(``assert_trees_close``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.rl import CriticSLAC as JaxCriticSLAC
from s2p_tpu.rl import SACTrainer as JaxSACTrainer
from s2p_tpu.rl import TanhGaussianPolicy as JaxTanhGaussianPolicy
from s2p_tpu.slac.networks import SlacGaussianPolicy as JaxSlacGaussianPolicy
from s2p_tpu.slac.networks import TwinnedQNetwork as JaxTwinnedQNetwork
from s2p_tpu_torch.nn.convert import jax_dense_tree_from_state_dict
from s2p_tpu_torch.rl import (
    CriticSLAC,
    SACTrainer,
    TanhGaussianPolicy,
    state_dict_from_jax_critic_params,
    state_dict_from_jax_policy_params,
)
from s2p_tpu_torch.slac import (
    SlacGaussianPolicy,
    TwinnedQNetwork,
    jax_slac_network_params_from_state_dict,
    state_dict_from_jax_slac_network_params,
)
from tests.test_torch_generator import seeded_params
from tests.test_torch_iql import IQL_BATCH as B
from tests.test_torch_iql import OBS, _np, _seeded_init, assert_metrics, state_batch
from tests.test_torch_slac import ACT, assert_grads_close, assert_trees_close

HIDDEN = (32, 32)


def make_sac_pair(seed=0, **kw):
    """(JAX trainer, port trainer) with the same seeded policy and critic."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTanhGaussianPolicy, "init", _seeded_init(JaxTanhGaussianPolicy, seed))
        mp.setattr(JaxCriticSLAC, "init", _seeded_init(JaxCriticSLAC, seed + 1))
        jtr = JaxSACTrainer(JaxTanhGaussianPolicy(HIDDEN, ACT), JaxCriticSLAC(HIDDEN), OBS, ACT,
                            **kw)
    policy = TanhGaussianPolicy(OBS, HIDDEN, ACT)
    policy.load_state_dict(state_dict_from_jax_policy_params(_np(jtr.policy_state.params)))
    critic = CriticSLAC(OBS, ACT, HIDDEN)
    critic.load_state_dict(state_dict_from_jax_critic_params(_np(jtr.critic_state.params)))
    return jtr, SACTrainer(policy, critic, device="cpu", **kw)


def jax_sac_draws(key, batch=B):
    """The ε of ``SACTrainer._step(..., key)``: k1 for α and the policy,
    k2 for the next actions."""
    k1, k2 = jax.random.split(key)
    return dict(pi=np.array(jax.random.normal(k1, (batch, ACT))),
                next=np.array(jax.random.normal(k2, (batch, ACT))))


def adam_moment(opt_state):
    return _np(opt_state[0].mu)


@pytest.mark.parametrize("auto_entropy", [True, False])
def test_sac_steps_match_jax(auto_entropy):
    """Two steps, target period 2: α → policy (one ε for both, the
    pre-update critic) → critic from the updated policy's next actions →
    targets at step 0 only."""
    jtr, tr = make_sac_pair(target_update_period=2, use_automatic_entropy_tuning=auto_entropy,
                            reward_scale=2.0)
    for i in range(2):
        batch, key = state_batch(10 + i), jax.random.PRNGKey(30 + i)
        targets_before = {k: v.clone() for k, v in tr.target_q.state_dict().items()}
        (jtr.policy_state, jtr.critic_state, jtr.target_q, jtr.log_alpha, jtr.alpha_opt_state,
         ref) = jtr._step(jtr.policy_state, jtr.critic_state, jtr.target_q, jtr.log_alpha,
                          jtr.alpha_opt_state, batch, jnp.uint32(i), key)
        got = tr.train(batch, draws=jax_sac_draws(key))
        assert_metrics(got, ref)
        moved = any(not torch.equal(v, targets_before[k])
                    for k, v in tr.target_q.state_dict().items())
        assert moved == (i == 0)
    lr = tr.critic_opt.param_groups[0]["lr"]
    assert_trees_close(jax_dense_tree_from_state_dict(tr.policy.state_dict()),
                       jtr.policy_state.params, lr=lr)
    assert_trees_close(jax_dense_tree_from_state_dict(tr.critic.state_dict()),
                       jtr.critic_state.params, lr=lr)
    assert_trees_close(jax_dense_tree_from_state_dict(tr.target_q.state_dict())["params"],
                       jtr.target_q, lr=lr)
    np.testing.assert_allclose(tr.log_alpha.item(), float(jtr.log_alpha), rtol=1e-5, atol=1e-7)
    # first moments: the policy's from its loss alone, the critic's (vf never
    # in a loss: zero) from the critic loss alone
    for opt, module, ref in ((tr.policy_opt, tr.policy, jtr.policy_state.opt_state),
                             (tr.critic_opt, tr.critic, jtr.critic_state.opt_state)):
        state = opt.state_dict()["state"]
        mu = {n: state[i]["exp_avg"] if i in state else torch.zeros_like(p)
              for i, (n, p) in enumerate(module.named_parameters())}
        assert_grads_close(jax_dense_tree_from_state_dict(mu), adam_moment(ref))
    assert tr.get_diagnostics()["num train calls"] == 2
    assert sorted(tr.get_snapshot()) == ["critic_params", "log_alpha", "policy_params",
                                         "target_q"]


def slac_networks(seed=0):
    jpol, jq = JaxSlacGaussianPolicy(ACT, hidden_units=(16, 16)), JaxTwinnedQNetwork((16, 16))
    fa, z = jnp.zeros((1, 20)), jnp.zeros((1, 12))
    pp = seeded_params(jpol.init, fa, seed=seed)
    qp = seeded_params(jq.init, z, jnp.zeros((1, ACT)), seed=seed + 1)
    pol, q = SlacGaussianPolicy(20, ACT, (16, 16)), TwinnedQNetwork(12, ACT, (16, 16))
    pol.load_state_dict(state_dict_from_jax_slac_network_params({"params": pp}), strict=True)
    q.load_state_dict(state_dict_from_jax_slac_network_params({"params": qp}), strict=True)
    return jpol, jq, pp, qp, pol, q


def test_slac_networks_match_jax():
    """Names (fc0..fc2; net{1,2}_fc{i}, net{1,2}_out), the deterministic
    action, a sample with JAX's ε and its log π, log-std clipping, and Q
    over [action ‖ z]."""
    jpol, jq, pp, qp, pol, q = slac_networks()
    assert sorted(pp) == ["fc0", "fc1", "fc2"]
    assert sorted(qp) == sorted(f"net{t}_{k}" for t in (1, 2) for k in ("fc0", "fc1", "out"))
    rs = np.random.RandomState(0)
    fa = (50.0 * rs.randn(5, 20)).astype(np.float32)  # wide enough to hit the log-std clip
    z, a = rs.randn(5, 12).astype(np.float32), rs.uniform(-1, 1, (5, ACT)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    det = jpol.apply({"params": pp}, fa)
    ja, jlp = jpol.apply({"params": pp}, fa, key, method=JaxSlacGaussianPolicy.sample)
    jdist = jpol.apply({"params": pp}, fa, method=JaxSlacGaussianPolicy.dist)
    jq1, jq2 = jq.apply({"params": qp}, z, a)
    with torch.no_grad():
        t = torch.from_numpy
        got_a, got_lp = pol.sample(t(fa), eps=t(np.array(jax.random.normal(key, (5, ACT)))))
        dist = pol.dist(t(fa))
        q1, q2 = q(t(z), t(a))
        np.testing.assert_allclose(pol(t(fa)).numpy(), np.asarray(det), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dist.scale.numpy(), np.asarray(jdist.scale), rtol=1e-5)
        np.testing.assert_allclose(q1.numpy(), np.asarray(jq1), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(q2.numpy(), np.asarray(jq2), rtol=1e-5, atol=1e-6)
    assert got_lp.shape == (5, 1)
    assert dist.scale.min() >= np.exp(-20.0) and dist.scale.max() <= np.exp(2.0) + 1e-6
    assert float(dist.scale.max()) == pytest.approx(np.exp(2.0), rel=1e-6)
    back = jax_slac_network_params_from_state_dict(q.state_dict())["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, qp)


@pytest.mark.parametrize("seed", [0, 1])
def test_slac_networks_init_is_seeded_xavier(seed):
    a, b = SlacGaussianPolicy(20, ACT, seed=seed), SlacGaussianPolicy(20, ACT, seed=seed)
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())
    q = TwinnedQNetwork(12, ACT, seed=seed)
    for name, p in list(a.named_parameters()) + list(q.named_parameters()):
        if name.endswith("bias"):
            assert not p.any(), name
        else:  # Glorot uniform: U(±√(6 / (fan_in + fan_out)))
            bound = np.sqrt(6.0 / sum(p.shape))
            assert p.abs().max() <= bound and p.abs().max() > 0.8 * bound, name
