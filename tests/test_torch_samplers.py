"""The port's agents, rollout and collectors (``s2p_tpu_torch.samplers``)
against the JAX package's.

Envs and stub policies are numpy on both sides, so paths and diagnostics
compare array for array. The policy crosses over as a seeded numpy flax
tree (``state_dict_from_jax_policy_params``); deterministic actions agree
within 1e-5. The SLAC rollouts carry a seeded latent into the port
(``tests/test_torch_slac.make_jax_slac``); on the ``latent_z`` branch the
posterior noise of each step is computed from the key JAX's
``prepare_batch`` takes (its ``RngStream``'s ``"prepare"`` stream) and
handed to the port, as ``test_torch_slac.jax_noise`` does. Actions within
1e-5, rewards within 1e-4 (MuJoCo integrates the 1e-7 action differences).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.envs import StubEnv as JaxStubEnv
from s2p_tpu.rl import TanhGaussianPolicy as JaxTanhGaussianPolicy
from s2p_tpu.samplers import MdpPathCollector as JaxMdpPathCollector
from s2p_tpu.samplers import MdpStepCollector as JaxMdpStepCollector
from s2p_tpu.samplers import PolicyAgent as JaxPolicyAgent
from s2p_tpu.samplers import SlacObservation as JaxSlacObservation
from s2p_tpu.samplers import rollout as jax_rollout
from s2p_tpu.slac import LatentModel as JaxLatentModel
from s2p_tpu.slac import SlacAlgorithm as JaxSlacAlgorithm
from s2p_tpu.testing import StubPolicy as JaxStubPolicy
from s2p_tpu.utils.seeding import RngStream
from s2p_tpu_torch.envs import StubEnv
from s2p_tpu_torch.rl import TanhGaussianPolicy
from s2p_tpu_torch.samplers import (
    MdpPathCollector,
    MdpStepCollector,
    PolicyAgent,
    RandomAgent,
    SlacObservation,
    rollout,
)
from s2p_tpu_torch.slac import SlacAlgorithm, state_dict_from_jax_latent_params
from s2p_tpu_torch.testing import StubPolicy
from tests.test_torch_generator import seeded_params
from tests.test_torch_slac import ACT, NS, SMALL, jax_noise

HIDDEN = (32, 32)


def policy_pair(in_dim: int, act_dim: int = ACT, seed: int = 0):
    """(JAX module, its seeded params, the port's policy with them)."""
    jpol = JaxTanhGaussianPolicy(HIDDEN, act_dim)
    params = {"params": seeded_params(jpol.init, jnp.zeros((1, in_dim)), seed=seed)}
    pol = TanhGaussianPolicy(in_dim, HIDDEN, act_dim)
    PolicyAgent(pol, params)  # loads the tree
    return jpol, params, pol


def slac_pair(action_dim: int, image_size: int, widths=SMALL, num_sequences: int = NS):
    """(JAX SlacAlgorithm, the port's) with one seeded latent (flax's own
    ``init`` is slow on the CPU: its params come from ``seeded_params``)."""
    orig = JaxLatentModel.init

    def fast_init(self, rng, *args):
        return {"params": seeded_params(functools.partial(orig, self), *args)}

    kw = dict(num_sequences=num_sequences, buffer_size=10, image_size=image_size, seed=0,
              **widths)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxLatentModel, "init", fast_init)
        jslac = JaxSlacAlgorithm(action_dim=action_dim, **kw)
    slac = SlacAlgorithm(action_dim, device="cpu", **kw)
    slac.latent.load_state_dict(state_dict_from_jax_latent_params(jslac.params), strict=True)
    return jslac, slac


@pytest.mark.parametrize("same", [False, True])
def test_slac_observation_matches_jax(same):
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 256, (6, 4, 4, 3), dtype=np.uint8)
    ob, ref = (cls((4, 4, 3), (2,), num_sequences=3, reset_w_same_obs=same)
               for cls in (SlacObservation, JaxSlacObservation))
    ob.reset_episode(frames[0])
    ref.reset_episode(frames[0])
    for i in range(6):
        np.testing.assert_array_equal(ob.state, ref.state)
        np.testing.assert_array_equal(ob.action, ref.action)
        assert ob.state.shape == (3, 4, 4, 3) and ob.action.shape == (4,)
        a = rs.uniform(-1, 1, 2)
        ob.append(frames[i], a)
        ref.append(frames[i], a)


def terminal_stub(base):
    """``base`` (either package's StubEnv) ending at step 3 with a true
    terminal (no truncation)."""

    class TerminalStub(base):
        def step(self, action):
            o, r, done, info = base.step(self, action)
            if self._t == 3:
                return o, r, True, {"TimeLimit.truncated": False}
            return o, r, done, info

    return TerminalStub


def _assert_paths_equal(got, want):
    assert len(got) == len(want)
    for p, q in zip(got, want):
        assert set(p) == set(q)
        for k in p:
            if k.endswith("infos"):
                assert p[k] == q[k], k
            else:
                np.testing.assert_array_equal(p[k], q[k], err_msg=k)


def test_rollout_splits_terminals_from_time_limits():
    for terminal in (False, True):
        env, ref = ((terminal_stub(cls) if terminal else cls)(max_episode_steps=4 + 6 * terminal)
                    for cls in (StubEnv, JaxStubEnv))
        path = rollout(env, StubPolicy([0.5, -0.5]), max_path_length=20)
        _assert_paths_equal([path], [jax_rollout(ref, JaxStubPolicy([0.5, -0.5]),
                                                 max_path_length=20)])
        assert path["dones"][-1, 0] and not path["dones"][:-1].any()
        assert path["terminals"][-1, 0] == terminal and not path["terminals"][:-1].any()
    path = rollout(StubEnv(max_episode_steps=10), StubPolicy([0.0, 0.0]), max_path_length=3)
    assert len(path["actions"]) == 3 and not path["dones"].any()
    frames = rollout(StubEnv(max_episode_steps=2), StubPolicy([0.0, 0.0]),
                     render_image_for_video_when_state_rl=True,
                     render_kwargs=dict(height=8, width=8))["image_observations"]
    assert frames.shape == (3, 8, 8, 3) and frames.dtype == np.uint8
    with pytest.raises(ValueError):
        rollout(StubEnv(), StubPolicy([0.0, 0.0]), slac_algo=object(),
                slac_policy_input_type="pixels")


@pytest.mark.parametrize("max_len,steps,discard", [(4, 10, True), (4, 10, False), (3, 9, True),
                                                   (20, 5, True), (20, 5, False)])
def test_path_collector_matches_jax(max_len, steps, discard):
    col = MdpPathCollector(StubEnv(max_episode_steps=4), StubPolicy([0.1, 0.2]),
                           max_num_epoch_paths_saved=2)
    ref = JaxMdpPathCollector(JaxStubEnv(max_episode_steps=4), JaxStubPolicy([0.1, 0.2]),
                              max_num_epoch_paths_saved=2)
    for epoch in range(2):
        got = col.collect_new_paths(max_len, steps, discard)
        _assert_paths_equal(got, ref.collect_new_paths(max_len, steps, discard))
        _assert_paths_equal(list(col.get_epoch_paths()), list(ref.get_epoch_paths()))
        assert list(col.get_diagnostics().items()) == list(ref.get_diagnostics().items())
        col.end_epoch(epoch)
        ref.end_epoch(epoch)
    assert len(col.get_epoch_paths()) == 0
    assert set(col.get_snapshot()) == {"policy", "env"}


@pytest.mark.parametrize("max_len,discard", [(3, True), (6, True), (6, False)])
def test_step_collector_matches_jax(max_len, discard):
    col = MdpStepCollector(StubEnv(max_episode_steps=4), StubPolicy([0.3, 0.0]))
    ref = JaxMdpStepCollector(JaxStubEnv(max_episode_steps=4), JaxStubPolicy([0.3, 0.0]))
    for epoch in range(2):
        for got, want in zip(col.collect_new_steps(max_len, 7, discard),
                             ref.collect_new_steps(max_len, 7, discard)):
            assert set(got) == set(want)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        _assert_paths_equal(list(col.get_epoch_paths()), list(ref.get_epoch_paths()))
        assert list(col.get_diagnostics().items()) == list(ref.get_diagnostics().items())
        col.end_epoch(epoch)
        ref.end_epoch(epoch)


def test_policy_agents_match_jax():
    in_dim = 5
    jpol, params, pol = policy_pair(in_dim)
    obs = np.random.RandomState(1).randn(4, in_dim).astype(np.float32)
    agent, ref = PolicyAgent(pol, deterministic=True), JaxPolicyAgent(jpol, params,
                                                                      deterministic=True)
    for o in obs:
        a, info = agent.get_action(o)
        assert a.dtype == np.float32 and a.shape == (ACT,) and info == {}
        np.testing.assert_allclose(a, ref.get_action(o)[0], rtol=1e-5, atol=1e-5)
    # a fresh module loading the snapshot tree acts the same
    other = PolicyAgent(TanhGaussianPolicy(in_dim, HIDDEN, ACT, seed=9), params,
                        deterministic=True)
    np.testing.assert_array_equal(other.get_action(obs[0])[0], agent.get_action(obs[0])[0])
    # stochastic: seeded, different per step, inside (-1, 1); the mode draws nothing
    draws = [PolicyAgent(pol, seed=3).get_action(obs[0])[0] for _ in range(2)]
    np.testing.assert_array_equal(draws[0], draws[1])
    stoch = PolicyAgent(pol, seed=3)
    a1, a2 = stoch.get_action(obs[0])[0], stoch.get_action(obs[0])[0]
    assert not np.array_equal(a1, a2) and (np.abs(a1) < 1).all()
    state = agent.generator.get_state()
    agent.get_action(torch.from_numpy(obs[0]))  # a tensor input too
    assert torch.equal(agent.generator.get_state(), state)
    agent.set_params(pol.state_dict())  # the port's own state dict
    with pytest.raises(RuntimeError):
        agent.set_params({"fc0.weight": torch.zeros(1)})
    box = StubEnv(action_dim=3).action_space
    box.seed(0)
    assert RandomAgent(box).get_action(None)[0].shape == (3,)


def test_walker_feature_action_rollout_matches_jax():
    pytest.importorskip("dm_control")
    from s2p_tpu.envs import make_dmc as jax_make_dmc
    from s2p_tpu_torch.envs import make_dmc

    jslac, slac = slac_pair(6, 64)  # walker's action dim
    jpol, params, pol = policy_pair(slac.feature_action_dim, act_dim=6)
    kw = dict(from_pixels=True, height=64, width=64, seed=2)
    slac_kw = dict(slac_policy_input_type="feature_action", slac_obs_reset_w_same_obs=True)
    with pytest.MonkeyPatch.context() as mp:  # a 10-step horizon
        path = rollout(_short(make_dmc("walker-walk", **kw), mp), PolicyAgent(pol,
                       deterministic=True), max_path_length=12, slac_algo=slac, **slac_kw)
        ref = jax_rollout(_short(jax_make_dmc("walker-walk", **kw), mp),
                          JaxPolicyAgent(jpol, params, deterministic=True), max_path_length=12,
                          slac_algo=jslac, **slac_kw)
    assert len(path["actions"]) == len(ref["actions"]) == 10 and path["dones"][-1, 0]
    np.testing.assert_allclose(path["actions"], ref["actions"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(path["rewards"], ref["rewards"], rtol=1e-4, atol=1e-4)
    assert np.abs(path["actions"]).max() > 1e-3  # the policy acts, not only its biases


def _short(env, mp, steps: int = 10):
    mp.setattr(env, "_max_episode_steps", steps)
    return env


def test_latent_z_rollout_matches_jax():
    jslac, slac = slac_pair(ACT, 64)
    jpol, params, pol = policy_pair(slac.z_dim)
    keys = RngStream(0)  # the stream JAX's SlacAlgorithm(seed=0) keys prepare_batch from
    noise = iter([jax_noise(keys.next("prepare"), 1, NS) for _ in range(5)])
    orig = slac.prepare_batch
    slac.prepare_batch = lambda obs, act: orig(obs, act, next(noise))
    kw = dict(image_shape=(64, 64, 3), action_dim=ACT, max_episode_steps=5)
    path = rollout(StubEnv(**kw), PolicyAgent(pol, deterministic=True), slac_algo=slac,
                   slac_policy_input_type="latent_z")
    ref = jax_rollout(JaxStubEnv(**kw), JaxPolicyAgent(jpol, params, deterministic=True),
                      slac_algo=jslac, slac_policy_input_type="latent_z")
    np.testing.assert_array_equal(path["observations"], ref["observations"])
    np.testing.assert_allclose(path["actions"], ref["actions"], rtol=1e-5, atol=1e-5)


def test_latent_z_divides_the_frames_as_jax():
    """The JAX rollout divides by 255 eagerly: a true f32 division, not the
    jitted product with f32(1/255) (they differ for about half the uint8
    values); the port's window must hold the same floats."""
    from s2p_tpu_torch.samplers.rollout import _latent_z

    frames = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, -1)
    seen = {}

    class Probe:
        device, num_sequences = torch.device("cpu"), 2

        def prepare_batch(self, obs, act):
            seen["obs"] = obs
            return (torch.zeros(1, 4),)

    ob = SlacObservation((16, 16, 3), (1,), num_sequences=2)
    ob.reset_episode(frames)
    _latent_z(Probe(), ob)
    want = np.asarray(jnp.asarray(ob.state, jnp.float32)[None] / 255.0)
    np.testing.assert_array_equal(seen["obs"].numpy(), want)
    jitted = np.asarray(jax.jit(lambda x: x.astype(jnp.float32) / 255.0)(frames))
    assert (jitted != want[0, -1]).any()
