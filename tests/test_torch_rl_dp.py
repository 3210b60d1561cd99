"""Data-parallel IQL, CQL and SLAC steps in the port: 2 gloo ranks on the CPU.

One spawn runs every case (``s2p_tpu_torch/testing/rl_dp_worker.py``) at
the dimensions of the JAX package's multi-device dry run
(``__graft_entry__.py:117-130, 222-241``: 4-step windows, 64px, action 4,
SLAC feature 16, z 4 + 8, heads 16 × 2, policy and critic 16); the tests
read what each rank reported. JAX's data-parallel step equals its step on
the global batch (each mean averages equal-size shards), so each rank's
step on its rows of a global batch, with JAX's draws for those rows, is
held to JAX's step on the whole batch with the same converted weights:
IQL + SLAC with the latent frozen; IQL + SLAC with the joint latent step on
a batch half real and half generated (each rank takes its half of each);
CQL + SLAC with the Lagrange term; the SLAC ELBO step; and the scanned
state IQL and CQL loops through ``train_many_dp`` on JAX's indices and
draws. Losses to 1e-5 relative; gradients, read from Adam's first moment,
to 1e-4 of the network's largest; weights after Adam to 1e-6 per step
where JAX's gradient is beyond that tolerance (Adam's first update moves a
weight by lr·g/(|g| + 1e-8), ≈ ±lr whatever |g|), within 2·lr per step
elsewhere."""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.data.hdf5 import make_synthetic_rl_dataset
from s2p_tpu.rl import CQLTrainer as JaxCQLTrainer
from s2p_tpu.rl import CriticSLAC as JaxCriticSLAC
from s2p_tpu.rl import IQLTrainer as JaxIQLTrainer
from s2p_tpu.rl import TanhGaussianPolicy as JaxTanhGaussianPolicy
from s2p_tpu.slac import LatentModel as JaxLatentModel
from s2p_tpu.slac import SlacAlgorithm as JaxSlacAlgorithm
from s2p_tpu_torch.data.replay import SlacReplayBuffer, window_batch
from s2p_tpu_torch.parallel import Mesh
from s2p_tpu_torch.parallel.distributed import spawn_ranks
from s2p_tpu_torch.rl import (CQLTrainer, CriticSLAC, TanhGaussianPolicy,
                              state_dict_from_jax_critic_params,
                              state_dict_from_jax_policy_params, train_many_dp)
from s2p_tpu_torch.slac import state_dict_from_jax_latent_params
from s2p_tpu_torch.testing import rl_dp_worker
from tests.test_torch_generator import seeded_params
from tests.test_torch_iql import _np, _seeded_init
from tests.test_torch_slac import jax_noise

WORLD = 2
ACT, NS, HW = 4, 4, 64
SLAC_KW = dict(feature_dim=16, z1_dim=4, z2_dim=8, hidden_units=(16, 16))
HIDDEN = (16,)
BATCH, LATENT_BATCH, N_RANDOM = 8, 4, 10
OBS, ROWS, STEPS = 6, 40, 3  # the state loops: 40 transitions, 3 scanned steps
POLICY_LR, QF_LR, LATENT_LR, TAU = 1e-4, 3e-4, 1e-4, 5e-3
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-4  # of the network's largest |gradient|


def rows_of(tree, idx):
    """Rows ``idx`` of every array or tensor of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: rows_of(v, idx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rows_of(v, idx) for v in tree)
    return tree[torch.as_tensor(idx)] if isinstance(tree, torch.Tensor) else tree[idx]


def rank_rows(n, rank, world=WORLD):
    return np.arange(rank * n // world, (rank + 1) * n // world)


def cql_draws(key, batch, slac):
    """JAX's draws of ``CQLTrainer._step_body(..., key)`` (``split(key, 8)``):
    posterior noise, the policy ε, the next-action ε, the uniform actions and
    the two tiled ε's."""
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


def cql_draw_rows(draws, idx):
    """The draws of batch rows ``idx``: the tiled draws hold N rows each."""
    tiled = np.concatenate([np.arange(i * N_RANDOM, (i + 1) * N_RANDOM) for i in idx])
    return {k: rows_of(v, tiled if k in ("random", "pi_tiled", "next_tiled") else idx)
            for k, v in draws.items()}


def make_jax_slac():
    """The JAX SLAC algorithm with seeded latent params (flax's own ``init``
    takes ~20 s on the CPU)."""
    orig = JaxLatentModel.init

    def fast_init(self, rng, *args):
        return {"params": seeded_params(functools.partial(orig, self), *args)}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxLatentModel, "init", fast_init)
        return JaxSlacAlgorithm(action_dim=ACT, num_sequences=NS, buffer_size=100,
                                batch_size_latent=LATENT_BATCH, image_size=HW, seed=0,
                                lr_latent=LATENT_LR, **SLAC_KW)


def jax_trainer(cls, obs_dim, policy_input_dim, slac=None, seed=0, **kw):
    """A JAX trainer with seeded networks, and the port's trainer arguments
    for the same weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTanhGaussianPolicy, "init", _seeded_init(JaxTanhGaussianPolicy, seed))
        mp.setattr(JaxCriticSLAC, "init", _seeded_init(JaxCriticSLAC, seed + 1))
        jtr = cls(JaxTanhGaussianPolicy(HIDDEN, ACT), JaxCriticSLAC(HIDDEN), obs_dim,
                  policy_input_dim, ACT, slac_algo=slac, **kw)
    port = dict(algo="iql" if cls is JaxIQLTrainer else "cql", obs_dim=obs_dim,
                policy=state_dict_from_jax_policy_params(_np(jtr.policy_state.params)),
                critic=state_dict_from_jax_critic_params(_np(jtr.critic_state.params)),
                kw=kw)
    return jtr, port


def reference(policy_state, critic_state, target_q, slac=None, temps=None):
    """JAX's state after a step in the layout ``view`` gives the port's."""
    out = dict(policy=(policy_state.params, policy_state.opt_state[0].mu),
               critic=(critic_state.params, critic_state.opt_state[0].mu),
               target_q=target_q)
    if slac is not None:
        out["slac"] = (slac[0], slac[1][0].mu)
    if temps is not None:
        (la, la_opt), (lap, lap_opt) = temps
        out["log_alpha"] = (la, la_opt[0].mu)
        out["log_alpha_prime"] = (lap, lap_opt[0].mu)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(out))


def view(state):
    """A rank's reported ``full_state`` as (weights, Adam's first moment)
    per network and temperature, and the target networks."""
    out = {net: (state[f"{net}_params"], state[f"{net}_opt"]["mu"])
           for net in ("policy", "critic", "slac") if f"{net}_params" in state}
    if "target_q" in state:
        out["target_q"] = state["target_q"]
    for name, opt in (("log_alpha", "alpha_opt"), ("log_alpha_prime", "alpha_prime_opt")):
        if name in state:
            out[name] = (state[name], state[opt]["mu"])
    return out


LRS = dict(policy=POLICY_LR, critic=QF_LR, slac=LATENT_LR, log_alpha=POLICY_LR,
           log_alpha_prime=QF_LR)


def check_state(got, ref, steps=1):
    """Gradients (Adam's first moments) to GRAD_TOL of the network's largest;
    weights to 1e-6 per step where JAX's moment is beyond that tolerance,
    within 2·lr per step elsewhere; the targets within the soft update's
    share of that."""
    got = view(got)
    assert sorted(got) == sorted(ref)
    for net, r in ref.items():
        if net == "target_q":
            for g, w in zip(jax.tree_util.tree_leaves(got[net]), jax.tree_util.tree_leaves(r)):
                np.testing.assert_allclose(g, w, rtol=0, atol=steps * (1e-6 + 2 * TAU * QF_LR))
            continue
        (g_w, g_mu), (r_w, r_mu) = got[net], r
        g_w, g_mu, r_w, r_mu = (jax.tree_util.tree_leaves(t) for t in (g_w, g_mu, r_w, r_mu))
        scale = max(float(np.abs(m).max()) for m in r_mu) or 1.0
        for gm, rm in zip(g_mu, r_mu):
            np.testing.assert_allclose(gm, rm, rtol=0, atol=GRAD_TOL * scale, err_msg=net)
        for gw, rw, rm in zip(g_w, r_w, r_mu):
            err = np.abs(np.asarray(gw, np.float64) - rw)
            determined = np.abs(rm) > GRAD_TOL * scale
            assert (err[determined] <= 1e-6 * steps).all(), (net, err[determined].max())
            assert (err <= 2 * LRS[net] * steps + 1e-6).all(), (net, err.max())


def check_metrics(got, ref):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], float(r), err_msg=k, **METRIC_TOL)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case's spec, JAX's step on each global batch (``ref``) and what
    every rank reported (``ranks``). The ranks run while JAX compiles."""
    tmp = tmp_path_factory.mktemp("rl_dp")
    jslac = make_jax_slac()
    real = make_synthetic_rl_dataset(2, 10, obs_dim=5, act_dim=ACT, img_hw=HW, seed=0)
    gen = make_synthetic_rl_dataset(2, 10, obs_dim=5, act_dim=ACT, img_hw=HW, seed=1)
    jslac.buffer.ingest_real(real)
    buf, buf_gen = (SlacReplayBuffer(100, NS, (HW, HW, 3), ACT, device="cpu") for _ in range(2))
    buf.ingest_real(real)
    buf_gen.ingest_real(gen)
    rs = np.random.RandomState(3)
    n_real = len(buf)
    slac_kw = dict(action_dim=ACT, num_sequences=NS, buffer_size=100,
                   batch_size_latent=LATENT_BATCH, image_size=HW, seed=0, lr_latent=LATENT_LR,
                   **SLAC_KW)
    fa_dim = NS * SLAC_KW["feature_dim"] + (NS - 1) * ACT
    z_dim = SLAC_KW["z1_dim"] + SLAC_KW["z2_dim"]

    def slac_batch(idx_real, idx_gen=None):
        parts = [buf.gather(torch.as_tensor(idx_real))]
        if idx_gen is not None:
            parts.append(buf_gen.gather(torch.as_tensor(idx_gen)))
        return window_batch(*(torch.cat(t) for t in zip(*parts)))

    cases, refs, jax_jobs = [], {}, []
    halves = [rank_rows(BATCH, r) for r in range(WORLD)]
    latent_halves = [rank_rows(LATENT_BATCH, r) for r in range(WORLD)]

    # IQL + SLAC, latent frozen
    jtr, port = jax_trainer(JaxIQLTrainer, z_dim, fa_dim, jslac, freeze_slac=True,
                            policy_lr=POLICY_LR, qf_lr=QF_LR)
    port["policy_input"] = "feature_action"
    idx = rs.randint(0, n_real, BATCH)
    batch, key = slac_batch(idx), jax.random.PRNGKey(11)
    noise = jax_noise(key, BATCH, NS + 1)
    cases.append(dict(name="iql_frozen", kind="train", mode="dp", trainer=port,
                      inputs=[dict(batch=rows_of(batch, h), draws=rows_of(noise, h))
                              for h in halves]))

    def iql_frozen(jtr=jtr, batch=batch, key=key):
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        p, c, t, m = jtr._step(jtr.policy_state, jtr.critic_state, jtr.target_q, jb,
                               jnp.uint32(0), True, jslac.params, key)
        return dict(m), reference(p, c, t, (jslac.params, jslac.opt_state))

    jax_jobs.append(("iql_frozen", iql_frozen))

    # IQL + SLAC, joint latent step, half of the batch real and half generated
    jtr, port = jax_trainer(JaxIQLTrainer, z_dim, fa_dim, jslac, seed=2,
                            policy_lr=POLICY_LR, qf_lr=QF_LR)
    port["policy_input"] = "feature_action"
    half = BATCH // 2
    idx_real, idx_gen = rs.randint(0, n_real, half), rs.randint(0, len(buf_gen), half)
    batch, key, k_lat = slac_batch(idx_real, idx_gen), jax.random.PRNGKey(12), \
        jax.random.PRNGKey(13)
    noise = jax_noise(key, BATCH, NS + 1)
    k_idx, k_noise = jax.random.split(k_lat)
    lat_idx = torch.from_numpy(np.asarray(
        jax.random.randint(k_idx, (LATENT_BATCH,), 0, n_real)).astype(np.int64))
    lat_noise = jax_noise(k_noise, LATENT_BATCH, NS + 1)
    # rank r: its rows of the real half, then its rows of the generated half
    mixed = [np.concatenate([rank_rows(half, r), half + rank_rows(half, r)])
             for r in range(WORLD)]
    joint_inputs = [dict(batch=rows_of(batch, m), draws=rows_of(noise, m),
                         latent_draws=(lat_idx[lh], rows_of(lat_noise, lh)))
                    for m, lh in zip(mixed, latent_halves)]
    joint = dict(kind="train", trainer=port)
    cases.append(dict(joint, name="iql_joint", mode="dp", inputs=joint_inputs))
    cases.append(dict(joint, name="iql_joint_no_sync", mode="no_sync", inputs=joint_inputs))
    cases.append(dict(joint, name="iql_joint_world1", mode="world1",
                      inputs=[dict(batch=batch, draws=noise, latent_draws=(lat_idx, lat_noise))]))

    def iql_joint(jtr=jtr, batch=batch, key=key, k_lat=k_lat):
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        p, c, t, m = jtr._step(jtr.policy_state, jtr.critic_state, jtr.target_q, jb,
                               jnp.uint32(0), True, jslac.params, key)
        lat, lat_opt, aux = jslac._latent_step(jslac.params, jslac.opt_state, LATENT_BATCH,
                                               jslac.buffer.device_state(), k_lat)
        m = dict(m, loss_kld=aux[0], loss_image=aux[1], loss_reward=aux[2])
        return m, reference(p, c, t, (lat, lat_opt))

    jax_jobs.append(("iql_joint", iql_joint))

    # CQL + SLAC with the Lagrange term (SAC's policy loss), latent frozen
    cql_kw = dict(with_lagrange=True, lagrange_thresh=2.0, policy_eval_start=0,
                  num_random=N_RANDOM, freeze_slac=True, policy_lr=POLICY_LR, qf_lr=QF_LR)
    jtr, port = jax_trainer(JaxCQLTrainer, z_dim, fa_dim, jslac, seed=4, **cql_kw)
    port["policy_input"] = "feature_action"
    idx = rs.randint(0, n_real, BATCH)
    batch, key = slac_batch(idx), jax.random.PRNGKey(14)
    batch["rewards"] = batch["rewards"] + torch.arange(float(BATCH))[:, None]
    draws = cql_draws(key, BATCH, slac=True)
    cql_inputs = [dict(batch=rows_of(batch, h), draws=cql_draw_rows(draws, h)) for h in halves]
    cql = dict(kind="train", trainer=port)
    cases.append(dict(cql, name="cql", mode="dp", inputs=cql_inputs))
    cases.append(dict(cql, name="cql_no_sync", mode="no_sync", inputs=cql_inputs))
    cases.append(dict(cql, name="cql_world1", mode="world1",
                      inputs=[dict(batch=batch, draws=draws)]))

    def cql_step(jtr=jtr, batch=batch, key=key):
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        out = jtr._step(jtr.policy_state, jtr.critic_state, jtr.target_q, jtr.log_alpha,
                        jtr.alpha_opt_state, jtr.log_alpha_prime, jtr.alpha_prime_opt_state,
                        jb, True, jnp.uint32(0), key, jslac.params)
        p, c, t, la, la_opt, lap, lap_opt, m = out
        return dict(m), reference(p, c, t, (jslac.params, jslac.opt_state),
                                  ((la, la_opt), (lap, lap_opt)))

    jax_jobs.append(("cql", cql_step))

    # the SLAC ELBO step
    k_elbo = jax.random.PRNGKey(15)
    k_idx, k_noise = jax.random.split(k_elbo)
    e_idx = torch.from_numpy(np.asarray(
        jax.random.randint(k_idx, (LATENT_BATCH,), 0, n_real)).astype(np.int64))
    e_noise = jax_noise(k_noise, LATENT_BATCH, NS + 1)
    cases.append(dict(name="elbo", kind="elbo", mode="dp",
                      inputs=[dict(idx=e_idx[lh], noise=rows_of(e_noise, lh))
                              for lh in latent_halves]))

    def elbo(k_elbo=k_elbo):
        lat, lat_opt, aux = jslac._latent_step(jslac.params, jslac.opt_state, LATENT_BATCH,
                                               jslac.buffer.device_state(), k_elbo)
        m = dict(loss_kld=aux[0], loss_image=aux[1], loss_reward=aux[2])
        return m, jax.tree_util.tree_map(np.asarray, jax.device_get(
            dict(slac=(lat, lat_opt[0].mu))))

    jax_jobs.append(("elbo", elbo))

    # the scanned state loops through train_many_dp, on JAX's indices and draws
    state_rows = dict(observations=rs.randn(ROWS, OBS), next_observations=rs.randn(ROWS, OBS),
                      actions=rs.uniform(-0.9, 0.9, (ROWS, ACT)), rewards=rs.randn(ROWS, 1),
                      terminals=(rs.rand(ROWS, 1) < 0.2))
    state_rows = {k: v.astype(np.float32) for k, v in state_rows.items()}
    buf_state = dict({k: jnp.asarray(v) for k, v in state_rows.items()}, n=jnp.int32(ROWS))
    for algo, cls, kw, key in (
            ("iql", JaxIQLTrainer, dict(policy_lr=POLICY_LR, qf_lr=QF_LR,
                                        target_update_period=2), jax.random.PRNGKey(16)),
            ("cql", JaxCQLTrainer, dict(with_lagrange=True, lagrange_thresh=-3.0,
                                        policy_eval_start=1, num_random=N_RANDOM,
                                        policy_lr=POLICY_LR, qf_lr=QF_LR,
                                        target_update_period=2), jax.random.PRNGKey(17))):
        jtr, port = jax_trainer(cls, OBS, OBS, seed=6, **kw)
        port["policy_input"] = "state"
        step_idx, step_draws = [], []
        for k_i in jax.random.split(key, STEPS):
            if algo == "cql":
                k_batch, k_step = jax.random.split(k_i)
                step_draws.append(cql_draws(k_step, BATCH, slac=False))
            else:
                k_batch = k_i
            step_idx.append(np.asarray(jax.random.randint(k_batch, (BATCH,), 0, ROWS)))
        step_idx = np.stack(step_idx)
        cases.append(dict(
            name=f"state_{algo}", kind="many", mode="dp", trainer=port, rows=state_rows,
            num_steps=STEPS, batch_size=BATCH,
            inputs=[dict(indices=step_idx[:, h],
                         draws=[cql_draw_rows(d, h) for d in step_draws] or None)
                    for h in halves]))

        def state_loop(jtr=jtr, key=key, algo=algo):
            if algo == "iql":
                (p, c, t), m = jtr._train_scan_state(
                    jtr.policy_state, jtr.critic_state, jtr.target_q, STEPS, BATCH,
                    buf_state, jnp.uint32(0), key)
                return dict(m), reference(p, c, t)
            carry0 = (jtr.policy_state, jtr.critic_state, jtr.target_q, jtr.log_alpha,
                      jtr.alpha_opt_state, jtr.log_alpha_prime, jtr.alpha_prime_opt_state)
            (p, c, t, la, la_opt, lap, lap_opt), m = jtr._train_scan_state(
                carry0, STEPS, BATCH, buf_state, jnp.uint32(0), key)
            return dict(m), reference(p, c, t, temps=((la, la_opt), (lap, lap_opt)))

        jax_jobs.append((f"state_{algo}", state_loop))

    # a latent batch that does not divide over the ranks
    cases.append(dict(name="odd_latent_batch", kind="elbo", mode="dp", inputs=[None] * WORLD,
                      slac=dict(batch_size_latent=LATENT_BATCH + 1)))

    spec = dict(slac=slac_kw, latent=state_dict_from_jax_latent_params(_np(jslac.params)),
                dataset=real, hidden=HIDDEN, cases=cases)
    torch.save(spec, tmp / "spec.pt")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_ranks, rl_dp_worker.run, WORLD,
                            (str(tmp / "spec.pt"), str(tmp)), timeout=300)
        for name, job in jax_jobs:
            refs[name] = job()
        ranks.result()
    return dict(ref=refs, cases={c["name"]: c for c in cases},
                ranks=[torch.load(tmp / f"rank{r}.pt", weights_only=False)
                       for r in range(WORLD)])


def result(run, case, rank=0):
    res = run["ranks"][rank][case]
    assert "error" not in res, res.get("error")
    return res


DP_CASES = [("iql_frozen", 1), ("iql_joint", 1), ("cql", 1), ("elbo", 1),
            ("state_iql", STEPS), ("state_cql", STEPS)]


@pytest.mark.parametrize("case,steps", DP_CASES)
def test_dp_step_matches_jax_global_batch(run, case, steps):
    got, (ref_metrics, ref_state) = result(run, case), run["ref"][case]
    check_metrics(got["metrics"], ref_metrics)
    check_state(got["state"], ref_state, steps)


@pytest.mark.parametrize("case", [c for c, _ in DP_CASES])
def test_ranks_hold_identical_state(run, case):
    r0, r1 = (result(run, case, r) for r in range(WORLD))
    assert r0["metrics"] == r1["metrics"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, r0["state"], r1["state"])


def test_the_joint_step_moved_the_latent_and_the_frozen_one_did_not(run):
    leaves = lambda case: jax.tree_util.tree_leaves(  # noqa: E731
        view(result(run, case)["state"])["slac"][0])
    start = jax.tree_util.tree_leaves(run["ref"]["iql_frozen"][1]["slac"][0])
    assert all(np.array_equal(a, b) for a, b in zip(leaves("iql_frozen"), start))
    assert not all(np.array_equal(a, b) for a, b in zip(leaves("iql_joint"), start))


@pytest.mark.parametrize("case", ["iql_joint", "cql"])
def test_without_the_sync_the_step_is_not_jax(run, case):
    """The mutation guard: each rank stepping on its own half (no gradient
    or metric average) fails the comparison the synced step passes."""
    ref_metrics, ref_state = run["ref"][case]
    for rank in range(WORLD):
        got = result(run, f"{case}_no_sync", rank)
        with pytest.raises(AssertionError):
            check_metrics(got["metrics"], ref_metrics)
        with pytest.raises(AssertionError):
            check_state(got["state"], ref_state)


@pytest.mark.parametrize("case", ["iql_joint", "cql"])
def test_world_one_group_is_the_single_process_step(run, case):
    got = result(run, f"{case}_world1")
    assert got["group"]["metrics"] == got["none"]["metrics"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, got["group"]["state"],
                           got["none"]["state"])


def test_a_latent_batch_that_does_not_divide_raises(run):
    err = run["ranks"][0]["odd_latent_batch"]["error"]
    assert "ValueError" in err and "does not divide" in err


@pytest.mark.parametrize("batch,dual", [(7, False), (6, True)])
def test_train_many_dp_rejects_a_batch_that_does_not_divide(batch, dual):
    mesh = Mesh({"data": 2, "model": 1}, [[0], [1]], {"data": 0, "model": 0},
                {"data": None, "model": None})
    tr = CQLTrainer(TanhGaussianPolicy(OBS, HIDDEN, ACT), CriticSLAC(OBS, ACT, HIDDEN),
                    device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        train_many_dp(tr, mesh, 1, batch, buffer=object(),
                      buffer_gen=object() if dual else None)
