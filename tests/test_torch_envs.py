"""The port's envs (``s2p_tpu_torch.envs``) against the JAX package's: the
numpy wrappers value for value, and the DeepMind Control envs (both wrap
``dm_control`` with the same seed) bit for bit: state observations, 64px
pixels, rewards and ``set_state``."""

import sys

import numpy as np
import pytest

from s2p_tpu.envs import NormalizedBoxEnv as JaxNormalizedBoxEnv
from s2p_tpu.envs import StubEnv as JaxStubEnv
from s2p_tpu.envs.wrappers import Box as JaxBox
from s2p_tpu_torch.envs import DMC_ENVS, Box, NormalizedBoxEnv, StubEnv, make_dmc


def test_box_matches_jax():
    for low, high, shape in ((-1.0, 1.0, (3,)), (np.zeros(2), np.array([1.0, np.inf]), None),
                             (0, 255, (4, 4, 3))):
        box, ref = Box(low, high, shape=shape), JaxBox(low, high, shape=shape)
        assert box.shape == ref.shape
        np.testing.assert_array_equal(box.low, ref.low)
        np.testing.assert_array_equal(box.high, ref.high)
        box.seed(3)
        ref.seed(3)
        for _ in range(3):
            s = box.sample()
            np.testing.assert_array_equal(s, ref.sample())
            assert box.contains(s) and ref.contains(s)
    assert not Box(-1.0, 1.0, shape=(2,)).contains(np.array([0.0, 2.0]))


@pytest.mark.parametrize("kw", [dict(obs_dim=5, action_dim=2, max_episode_steps=4),
                                dict(image_shape=(8, 8, 3), action_dim=3, max_episode_steps=3)])
def test_stub_env_matches_jax(kw):
    env, ref = StubEnv(**kw), JaxStubEnv(**kw)
    assert env.observation_space.shape == ref.observation_space.shape
    assert env.observation_space.dtype == ref.observation_space.dtype
    np.testing.assert_array_equal(env.reset(), ref.reset())
    for _ in range(kw["max_episode_steps"]):
        a = np.zeros(kw["action_dim"])
        got, want = env.step(a), ref.step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert got[2] and got[3]["TimeLimit.truncated"]
    np.testing.assert_array_equal(env.render(height=4, width=6), ref.render(height=4, width=6))


def test_normalized_box_env_matches_jax():
    class Wide(StubEnv):
        def __init__(self):
            super().__init__(obs_dim=3, action_dim=2)
            self.action_space = Box(np.array([-2.0, 0.0]), np.array([2.0, 10.0]))
            self.seen = []

        def step(self, action):
            self.seen.append(np.asarray(action))
            return super().step(action)

    kw = dict(reward_scale=2.5, obs_mean=np.full(3, 0.5), obs_std=np.full(3, 2.0))
    for extra in (kw, {}):
        inner, ref_inner = Wide(), Wide()
        env, ref = NormalizedBoxEnv(inner, **extra), JaxNormalizedBoxEnv(ref_inner, **extra)
        np.testing.assert_array_equal(env.reset(), ref.reset())
        np.testing.assert_array_equal(env.action_space.high, np.ones(2))
        for a in (np.array([-1.0, 1.0]), np.array([0.5, -3.0])):
            got, want = env.step(a), ref.step(a)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
        np.testing.assert_array_equal(np.stack(inner.seen), np.stack(ref_inner.seen))
        assert env.max_episode_steps == 10  # attributes reach the wrapped env


def _steps(env, actions):
    out = [env.reset()]
    for a in actions:
        o, r, d, info = env.step(a)
        out.append((o, r, d, info))
    return out


@pytest.mark.parametrize("pixels", [False, True])
def test_dmc_cheetah_is_bit_equal_to_jax(pixels):
    pytest.importorskip("dm_control")
    from s2p_tpu.envs import make_dmc as jax_make_dmc

    kw = dict(from_pixels=pixels, height=64, width=64, seed=7)
    env, ref = make_dmc("cheetah-run", **kw), jax_make_dmc("cheetah-run", **kw)
    assert env._max_episode_steps == ref._max_episode_steps == 250
    assert env.observation_space.shape == ref.observation_space.shape
    assert env.observation_space.shape == ((64, 64, 3) if pixels else (17,))
    actions = np.random.RandomState(0).uniform(-1.5, 1.5, (4, 6))
    got, want = _steps(env, actions), _steps(ref, actions)
    np.testing.assert_array_equal(got[0], want[0])
    for (o, r, d, info), (o2, r2, d2, info2) in zip(got[1:], want[1:]):
        assert o.dtype == o2.dtype and r == r2 and d == d2 and info == info2
        np.testing.assert_array_equal(o, o2)
    assert any(r != 0.0 for _, r, _, _ in got[1:]) or pixels

    if pixels:  # state → render replay
        qpos, qvel = env.physics.data.qpos.copy() * 0.5, env.physics.data.qvel.copy()
        env.set_state(qpos, qvel)
        ref.set_state(qpos, qvel)
        np.testing.assert_array_equal(env.physics.data.qpos, qpos)
        np.testing.assert_array_equal(env.render(), ref.render())
        np.testing.assert_array_equal(env.render(height=32, width=48, camera_id=1),
                                      ref.render(height=32, width=48, camera_id=1))


def test_dmc_registry_and_truncation():
    pytest.importorskip("dm_control")
    from s2p_tpu.envs import DMC_ENVS as JAX_DMC_ENVS

    assert DMC_ENVS == JAX_DMC_ENVS
    env = make_dmc(domain_name="cartpole", task_name="swingup", frame_skip=8, seed=0)
    env._max_episode_steps = 2
    env.reset()
    assert env.step(np.zeros(1))[2:] == (False, {"TimeLimit.truncated": False})
    assert env.step(np.zeros(1))[2:] == (True, {"TimeLimit.truncated": True})
    with pytest.raises(ValueError):
        make_dmc()


def test_make_dmc_raises_without_dm_control(monkeypatch):
    monkeypatch.setitem(sys.modules, "dm_control", None)  # import fails
    with pytest.raises(ImportError, match="dm_control"):
        make_dmc("cheetah-run")
