"""The port's plain helpers of the RL path (``utils.config``, ``utils.stats``,
``testing.csv_util``, ``testing.stubs``, ``data.env_replay_buffer``,
``data.path_loaders``) against the JAX package's on the same inputs,
exactly."""

import json

import numpy as np
import pytest

from s2p_tpu.data.env_replay_buffer import EnvReplayBuffer as JaxEnvReplayBuffer
from s2p_tpu.data.env_replay_buffer import FixedNormalizer as JaxFixedNormalizer
from s2p_tpu.data.env_replay_buffer import Normalizer as JaxNormalizer
from s2p_tpu.data.env_replay_buffer import PathBuilder as JaxPathBuilder
from s2p_tpu.data.path_loaders import DictToMDPPathLoader as JaxDictLoader
from s2p_tpu.data.path_loaders import HDF5PathLoader as JaxHDF5Loader
from s2p_tpu.envs import StubEnv as JaxStubEnv
from s2p_tpu.testing import AddEs as JaxAddEs
from s2p_tpu.testing import StubPolicy as JaxStubPolicy
from s2p_tpu.testing import check_equal as jax_check_equal
from s2p_tpu.testing import get_exp as jax_get_exp
from s2p_tpu.testing.stubs import is_binomial_trial_likely as jax_binomial
from s2p_tpu.utils.config import Config as JaxConfig
from s2p_tpu.utils.stats import create_stats_ordered_dict as jax_stats
from s2p_tpu.utils.stats import get_generic_path_information as jax_path_info
from s2p_tpu.utils.stats import list_of_dicts_to_dict_of_lists as jax_lod
from s2p_tpu_torch.data.env_replay_buffer import (
    EnvReplayBuffer,
    FixedNormalizer,
    Normalizer,
    PathBuilder,
)
from s2p_tpu_torch.data.path_loaders import DictToMDPPathLoader, HDF5PathLoader
from s2p_tpu_torch.envs import StubEnv
from s2p_tpu_torch.testing import (
    AddEs,
    StubPolicy,
    check_equal,
    check_exactly_equal,
    get_exp,
    is_binomial_trial_likely,
)
from s2p_tpu_torch.utils.config import Config
from s2p_tpu_torch.utils.stats import (
    create_stats_ordered_dict,
    get_generic_path_information,
    list_of_dicts_to_dict_of_lists,
)

VARIANT = dict(algo_kwargs=dict(batch_size=128, num_epochs=np.int64(3)),
               trainer_kwargs=dict(discount=0.99, lr=np.float32(3e-4)),
               layers=[dict(size=256), dict(size=256)], seed=0, name="iql", shape=np.zeros(2))


def test_config_matches_jax():
    c, j = Config(VARIANT), JaxConfig(VARIANT)
    assert c.trainer_kwargs.discount == j.trainer_kwargs.discount == 0.99
    assert c.to_json() == j.to_json() and c.to_dict() == j.to_dict()
    assert c.flatten() == j.flatten()
    upd = dict(trainer_kwargs=dict(discount=0.9, beta=0.1), seed=3)
    assert c.deep_update(upd).to_json() == j.deep_update(upd).to_json()
    assert c.trainer_kwargs.discount == 0.99  # deep_update copies
    for cfg in (c, j):
        cfg.set_path("a.b.c", 1)
        cfg.extra = dict(x=1)
        del cfg.seed
    assert c.get_path("a.b.c") == j.get_path("a.b.c") == 1
    assert c.get_path("a.x", "d") == j.get_path("a.x", "d") == "d"
    assert isinstance(c.extra, Config) and isinstance(c.layers[0], Config)
    assert c.to_json() == j.to_json()
    assert Config.from_json(c.to_json()) == json.loads(j.to_json())
    with pytest.raises(AttributeError):
        c.missing


def paths(seed=0):
    rs = np.random.RandomState(seed)
    return [dict(rewards=rs.randn(n, 1), actions=rs.uniform(-1, 1, (n, 3)))
            for n in (5, 3, 7)]


@pytest.mark.parametrize("args", [
    ("x", [1.0, 2.0, 5.0]), ("x", [], "p/"), ("x", 3.0, "", False),
    ("x", np.arange(6.0).reshape(2, 3), "", True, True), ("x", [[1.5]], "", True)])
def test_stats_match_jax(args):
    assert list(create_stats_ordered_dict(*args).items()) == list(jax_stats(*args).items())


def test_path_information_matches_jax():
    for ps, prefix in ((paths(), ""), (paths(1)[:1], "eval/"), ([], "")):
        assert (list(get_generic_path_information(ps, prefix).items())
                == list(jax_path_info(ps, prefix).items()))
    no_actions = [dict(rewards=p["rewards"]) for p in paths(2)]
    assert get_generic_path_information(no_actions) == jax_path_info(no_actions)
    dicts = [dict(a=1, b=2), dict(a=3), dict(c=4)]
    assert list_of_dicts_to_dict_of_lists(dicts) == jax_lod(dicts)


def test_csv_util_matches_jax(tmp_path):
    path = tmp_path / "progress.csv"
    path.write_text("epoch,loss,name,nan\n0,1.0,a,nan\n1,0.5000001,b,nan\n")
    rows = get_exp(str(path))
    assert rows == jax_get_exp(str(path))
    other = [dict(r) for r in rows]
    other[1]["loss"] = "0.5"
    keys = ["epoch", "loss", "name", "nan"]
    check_equal(rows, other, keys, rel_tol=1e-5)
    jax_check_equal(rows, other, keys, rel_tol=1e-5)
    for check in (lambda: check_exactly_equal(rows, other, keys),
                  lambda: check_equal(rows, other[:1], keys)):
        with pytest.raises(AssertionError):
            check()
    other[1]["name"] = "c"
    with pytest.raises(AssertionError):
        check_equal(rows, other, ["name"])


def test_stubs_match_jax():
    obs = np.zeros(4)
    port, ref = StubPolicy([0.5, -1.0]), JaxStubPolicy([0.5, -1.0])
    a, info = port.get_action(obs)
    np.testing.assert_array_equal(a, ref.get_action(obs)[0])
    a[0] = 9.0  # a copy
    assert port.get_action(obs)[0][0] == 0.5 and info == {}
    es, jes = AddEs(2.0), JaxAddEs(2.0)
    pol = StubPolicy([1.0])
    np.testing.assert_array_equal(es.get_action(0, obs, pol)[0], jes.get_action(0, obs, pol)[0])
    assert es.get_action_from_raw_action(1.0) == jes.get_action_from_raw_action(1.0) == 3.0
    for n, p, k in ((100, 0.5, 50), (100, 0.5, 80), (10, 0.1, 1)):
        assert is_binomial_trial_likely(n, p, k) == jax_binomial(n, p, k)


def test_buffers_loaders_and_normalizers_match_jax():
    rs = np.random.RandomState(0)
    n = 7
    ds = dict(observations=rs.randn(n, 3), actions=rs.uniform(-1, 1, (n, 2)),
              rewards=rs.randn(n, 1), terminals=(rs.rand(n) < 0.3).astype(np.float32),
              next_observations=rs.randn(n, 3))
    path = dict(observations=rs.randn(4, 3), actions=rs.randn(4, 2), rewards=rs.randn(4))
    bufs = []
    for env_cls, buf_cls, hdf5, loader, kw in (
            (StubEnv, EnvReplayBuffer, HDF5PathLoader, DictToMDPPathLoader, {"device": "cpu"}),
            (JaxStubEnv, JaxEnvReplayBuffer, JaxHDF5Loader, JaxDictLoader, {})):
        buf = buf_cls(20, env_cls(obs_dim=3, action_dim=2), **kw)
        assert hdf5(None, buf, obs_preprocessor=lambda o: 2 * o).load_demos([ds]) == n
        assert loader(buf, [path], reward_scale=3.0).load_demos() == 4
        bufs.append(buf.random_batch(8, rng=np.random.RandomState(1)))
    for k in bufs[0]:
        np.testing.assert_array_equal(bufs[0][k], bufs[1][k], err_msg=k)

    data = rs.randn(50, 4)
    norm, ref = Normalizer(4, default_clip_range=2.0), JaxNormalizer(4, default_clip_range=2.0)
    for nm in (norm, ref):
        nm.update(data[:30])
        nm.update(data[30:])
    np.testing.assert_array_equal(norm.normalize(data), ref.normalize(data))
    np.testing.assert_array_equal(norm.denormalize(data), ref.denormalize(data))
    fixed, jfixed = FixedNormalizer(4), JaxFixedNormalizer(4)
    for f in (fixed, jfixed):
        f.copy_stats(norm)
    np.testing.assert_array_equal(fixed.normalize(data, 1.0), jfixed.normalize(data, 1.0))
    pb, jpb = PathBuilder(), JaxPathBuilder()
    for b in (pb, jpb):
        for i in range(3):
            b.add_all(obs=np.full(2, i), info={"i": i})
    got, want = pb.get_all_stacked(), jpb.get_all_stacked()
    assert len(pb) == len(jpb) == 3 and got["info"] == want["info"]
    np.testing.assert_array_equal(got["obs"], want["obs"])
