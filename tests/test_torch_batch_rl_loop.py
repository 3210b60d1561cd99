"""The port's batch and online RL loops (``s2p_tpu_torch.core``) against the
JAX package's.

Both loops run the same numpy stub trainer over numpy stub envs, stub
policies and flat "rng" buffers (``EnvReplayBuffer``), whose draws come
from one seeded ``RandomState`` in the same order on both sides: the
progress.csv files must be equal key for key and value for value, but for
the wall-clock ``time/`` columns, and so must the snapshots and
``rewards_list.pkl``."""

import copy
import csv
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from s2p_tpu.core import BatchRLAlgorithm as JaxBatchRLAlgorithm
from s2p_tpu.core import OnlineRLAlgorithm as JaxOnlineRLAlgorithm
from s2p_tpu.data.env_replay_buffer import EnvReplayBuffer as JaxEnvReplayBuffer
from s2p_tpu.envs import StubEnv as JaxStubEnv
from s2p_tpu.samplers import MdpPathCollector as JaxMdpPathCollector
from s2p_tpu.samplers import MdpStepCollector as JaxMdpStepCollector
from s2p_tpu.testing import StubPolicy as JaxStubPolicy
from s2p_tpu.utils.logging import Logger as JaxLogger
from s2p_tpu_torch.core import BatchRLAlgorithm, OnlineRLAlgorithm
from s2p_tpu_torch.data.env_replay_buffer import EnvReplayBuffer
from s2p_tpu_torch.envs import StubEnv
from s2p_tpu_torch.rl import TanhGaussianPolicy
from s2p_tpu_torch.samplers import MdpPathCollector, MdpStepCollector, PolicyAgent
from s2p_tpu_torch.testing import StubPolicy
from s2p_tpu_torch.utils.logging import Logger

OBS, ACT = 3, 2


class NumpyTrainer:
    """Diagnostics from the batches it sees: their sizes and the means of
    their first and second halves, per key; a numpy snapshot."""

    device = torch.device("cpu")

    def __init__(self):
        self._n_train_steps_total, self.stats, self.many = 0, {}, []

    def train(self, batch):
        self._n_train_steps_total += 1
        b = {k: np.asarray(v, np.float64) for k, v in batch.items()}
        half = len(b["rewards"]) // 2
        self.stats = {"batch": len(b["rewards"])}
        for k, v in sorted(b.items()):
            self.stats[f"{k} head"] = v[:half].mean()
            self.stats[f"{k} tail"] = v[half:].mean()
        return {"loss": np.float32(self.stats["rewards head"])}

    def train_many(self, num_steps, batch_size, buffer=None, buffer_gen=None):
        self.many.append((num_steps, batch_size, buffer, buffer_gen))
        self._n_train_steps_total += num_steps
        return {"loss": np.float32(0.0)}

    def get_diagnostics(self):
        return dict(self.stats, **{"num train calls": float(self._n_train_steps_total)})

    def get_snapshot(self):
        return {"steps": np.full(2, self._n_train_steps_total, np.float32)}

    def end_epoch(self, epoch):
        pass


def _buffer(cls, env, n=30, seed=0):
    rs = np.random.RandomState(seed)
    buf = cls(200, env, **({"device": "cpu"} if cls is EnvReplayBuffer else {}))
    for _ in range(n):
        buf.add_sample(rs.randn(OBS), rs.uniform(-1, 1, ACT), rs.randn(), 0.0, rs.randn(OBS))
    return buf


SIDES = dict(
    port=dict(algo=BatchRLAlgorithm, online=OnlineRLAlgorithm, env=StubEnv,
              policy=StubPolicy, paths=MdpPathCollector, steps=MdpStepCollector,
              buffer=EnvReplayBuffer, logger=Logger),
    jax=dict(algo=JaxBatchRLAlgorithm, online=JaxOnlineRLAlgorithm, env=JaxStubEnv,
             policy=JaxStubPolicy, paths=JaxMdpPathCollector, steps=JaxMdpStepCollector,
             buffer=JaxEnvReplayBuffer, logger=JaxLogger))


def run(side, tmp_path, online=False, dual=False, snapshot_gap=10, **kw):
    """One seeded loop of ``side``; returns (log dir, trainer)."""
    s = SIDES[side]
    env_kw = dict(obs_dim=OBS, action_dim=ACT, max_episode_steps=4)
    eval_env, expl_env = s["env"](**env_kw), s["env"](**env_kw)
    eval_col = s["paths"](eval_env, s["policy"]([0.1, -0.2]))
    expl_col = s["steps" if online else "paths"](expl_env, s["policy"]([0.3, 0.4]))
    log = s["logger"]()
    log_dir = str(tmp_path / side)
    log.set_log_dir(log_dir)
    log.set_snapshot_mode("gap_and_last")
    log.set_snapshot_gap(2)
    trainer = NumpyTrainer()
    args = dict(trainer=trainer, exploration_env=expl_env, evaluation_env=eval_env,
                exploration_data_collector=expl_col, evaluation_data_collector=eval_col,
                replay_buffer=_buffer(s["buffer"], eval_env),
                batch_size=6, max_path_length=4, num_epochs=3, num_eval_steps_per_epoch=8,
                num_expl_steps_per_train_loop=5, logger=log, seed=7, snapshot_gap=snapshot_gap)
    if online:
        algo = s["online"](num_trains_per_expl_step=2, min_num_steps_before_training=3,
                           **args, **kw)
    else:
        if dual:
            args["replay_buffer_gen"] = _buffer(s["buffer"], eval_env, n=20, seed=1)
        algo = s["algo"](num_trains_per_train_loop=3, num_train_loops_per_epoch=2,
                         min_num_steps_before_training=6, **args, **kw)
    algo.train()
    log.close()
    return log_dir, trainer


def rows(log_dir):
    with open(os.path.join(log_dir, "progress.csv"), newline="") as f:
        return list(csv.DictReader(f))


def assert_runs_equal(tmp_path, **kw):
    port_dir, _ = run("port", tmp_path, **kw)
    jax_dir, _ = run("jax", tmp_path, **kw)
    got, want = rows(port_dir), rows(jax_dir)
    assert list(got[0]) == list(want[0]) and len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if not k.startswith("time/")} == \
               {k: v for k, v in w.items() if not k.startswith("time/")}
    assert sum(k.startswith("time/") for k in got[0]) == 8
    files = sorted(f for f in os.listdir(port_dir) if f.endswith(".pkl"))
    assert files == sorted(f for f in os.listdir(jax_dir) if f.endswith(".pkl"))
    for name in files:
        with open(os.path.join(port_dir, name), "rb") as f, \
                open(os.path.join(jax_dir, name), "rb") as g:
            a, b = pickle.load(f), pickle.load(g)
        if name == "rewards_list.pkl":
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    return got


@pytest.mark.parametrize("start_epoch", [0, -2])
@pytest.mark.parametrize("eval_period", [1, 2])
def test_batch_loop_matches_jax(tmp_path, start_epoch, eval_period):
    got = assert_runs_equal(tmp_path, start_epoch=start_epoch, eval_period=eval_period,
                            snapshot_gap=2)
    fresh = [int(r["eval/is_fresh"]) for r in got]
    assert fresh == ([1] * len(got) if eval_period == 1 else
                     [int((i % 2 == 0) or i == len(got) - 1) for i in range(len(got))])
    if eval_period == 2:  # carried-forward rows repeat the last fresh stats
        assert got[1]["eval/Returns Mean"] == got[0]["eval/Returns Mean"]


def test_dual_buffer_batches_are_half_real_half_generated(tmp_path):
    got = assert_runs_equal(tmp_path, dual=True, start_epoch=-1)
    last = got[-1]
    assert float(last["trainer/batch"]) == 6.0
    # the generated buffer's rewards come from another seed: the halves differ
    assert last["trainer/rewards head"] != last["trainer/rewards tail"]


class _Scannable:
    """A SLAC-like buffer, scannable or not, that takes its generator by keyword."""

    sampling_style = "generator"

    def __init__(self, scannable):
        self.scannable = scannable

    def random_batch(self, batch_size, *, generator):
        assert isinstance(generator, torch.Generator)
        return {"rewards": torch.ones(batch_size, 1), "observations": torch.zeros(batch_size, 2)}

    def get_diagnostics(self):
        return {}

    def end_epoch(self, epoch):
        pass


@pytest.mark.parametrize("scan,main_ok,gen_ok,dispatched", [
    (True, True, None, True), (True, True, True, True), (True, True, False, False),
    (True, False, None, False), (False, True, True, False)])
def test_scan_training_dispatch(scan, main_ok, gen_ok, dispatched):
    trainer = NumpyTrainer()
    main_buf = _Scannable(main_ok)
    gen_buf = None if gen_ok is None else _Scannable(gen_ok)
    env = StubEnv(obs_dim=OBS, action_dim=ACT, max_episode_steps=2)
    col = MdpPathCollector(env, StubPolicy([0.0, 0.0]))
    algo = BatchRLAlgorithm(trainer, env, env, col, col, main_buf, batch_size=4,
                            max_path_length=2, num_epochs=1, num_eval_steps_per_epoch=2,
                            num_expl_steps_per_train_loop=2, num_trains_per_train_loop=3,
                            start_epoch=-1, replay_buffer_gen=gen_buf, logger=Logger(),
                            slac_representation=True, scan_training=scan)
    assert algo.scan_training == dispatched
    jax_algo = JaxBatchRLAlgorithm(trainer, env, env, col, col, main_buf, batch_size=4,
                                   max_path_length=2, num_epochs=1, num_eval_steps_per_epoch=2,
                                   num_expl_steps_per_train_loop=2, num_trains_per_train_loop=3,
                                   replay_buffer_gen=gen_buf, scan_training=scan)
    assert jax_algo.scan_training == dispatched
    algo.train()
    assert trainer._n_train_steps_total == 6
    if dispatched:
        assert trainer.many == [(3, 4, main_buf, gen_buf)] * 2
    else:
        assert trainer.many == [] and trainer.stats["batch"] == 4


def test_online_loop_matches_jax(tmp_path):
    got = assert_runs_equal(tmp_path, online=True)
    assert [float(r["replay_buffer/size"]) for r in got] == [30.0 + 3 + 5 * i for i in (1, 2, 3)]


def test_shared_policy_acts_as_a_synced_copy(tmp_path):
    """An agent on the trainer's own policy module acts as the JAX agents
    do, which hold a copy refreshed by a post-epoch hook: acting comes
    before training in each epoch and the hooks after the epoch's stats."""

    class Perturbing(NumpyTrainer):
        def __init__(self, policy):
            super().__init__()
            self.policy = policy

        def train(self, batch):
            with torch.no_grad():
                for p in self.policy.parameters():
                    p.add_(0.05 * torch.sin(p * 7.0 + self._n_train_steps_total))
            return super().train(batch)

    actions = []
    for shared in (True, False):
        policy = TanhGaussianPolicy(OBS, (8,), ACT, seed=0)
        trainer = Perturbing(policy)
        agent_module = policy if shared else copy.deepcopy(policy)
        agent = PolicyAgent(agent_module, deterministic=True)
        env = StubEnv(obs_dim=OBS, action_dim=ACT, max_episode_steps=3)
        eval_col = MdpPathCollector(env, agent)
        expl_col = MdpPathCollector(StubEnv(obs_dim=OBS, action_dim=ACT, max_episode_steps=3),
                                    StubPolicy([0.0, 0.0]))
        log = Logger()
        log.set_log_dir(str(tmp_path / str(shared)))
        algo = BatchRLAlgorithm(trainer, env, env, expl_col, eval_col,
                                _buffer(EnvReplayBuffer, env), batch_size=4, max_path_length=3,
                                num_epochs=3, num_eval_steps_per_epoch=3,
                                num_expl_steps_per_train_loop=3, num_trains_per_train_loop=2,
                                logger=log)
        if not shared:
            algo.post_epoch_funcs.append(
                lambda algo, epoch: agent.set_params(algo.trainer.policy.state_dict()))
        algo.train()
        log.close()
        actions.append([r["eval/Actions Mean"] for r in rows(str(tmp_path / str(shared)))])
    assert actions[0] == actions[1] and len(set(actions[0])) == 3


def test_video_hook_writes_on_its_period_and_needs_imageio(tmp_path, monkeypatch):
    from s2p_tpu_torch.core import VideoSaveFunction

    env = StubEnv(image_shape=(8, 8, 3), action_dim=ACT, max_episode_steps=3)
    hook = VideoSaveFunction(env, StubPolicy([0.0, 0.0]), str(tmp_path), save_video_period=2,
                             horizon=3, fps=5)
    algo = type("Loop", (), {"num_epochs": 5})()
    assert hook(algo, 1) is None
    path = hook(algo, 2)  # mp4, or gif where imageio has no mp4 writer
    assert path.startswith(str(tmp_path / "videos" / "eval_video_2_env."))
    assert os.path.getsize(path) > 0
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError):
        hook(algo, 4)  # the last epoch
