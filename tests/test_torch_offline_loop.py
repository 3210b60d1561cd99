"""The replay buffers' sampling contract, the env-free offline loop and its
logging and timing pieces (s2p_tpu_torch.{data.replay, core, utils}) against
the JAX package's.

The loops dispatch on a buffer's ``sampling_style`` and, for on-device
sampling, its ``scannable``: the port's buffers declare both, ``scannable``
as the JAX buffers compute it for the same constructor arguments, and the
port's ``SimpleOfflineRlAlgorithm`` passes its generator (SLAC buffer) or
its numpy ``RandomState`` (flat buffer) by keyword; stub buffers whose
``random_batch`` refuses a positional second argument prove it."""

import csv
import os
import pickle

import numpy as np
import pytest
import torch

from s2p_tpu.core import SimpleOfflineRlAlgorithm as JaxSimpleOfflineRlAlgorithm
from s2p_tpu.data.replay import SimpleReplayBuffer as JaxSimpleReplayBuffer
from s2p_tpu.data.replay import SlacReplayBuffer as JaxSlacReplayBuffer
from s2p_tpu.utils.logging import Logger as JaxLogger
from s2p_tpu_torch.core import LossFunction, Serializable, SimpleOfflineRlAlgorithm, Trainer
from s2p_tpu_torch.data.replay import SimpleReplayBuffer, SlacReplayBuffer
from s2p_tpu_torch.rl import CQLTrainer, CriticSLAC, TanhGaussianPolicy
from s2p_tpu_torch.slac import SlacAlgorithm
from s2p_tpu_torch.utils.logging import Logger, logger
from s2p_tpu_torch.utils.timer import PhaseTimer, Timer, block_until_ready
from tests.test_torch_slac import ACT, NS, SMALL, dataset

OBS = 6
FLAT_MODES = [  # (observation_dim, image_buffer, memory_efficient_way)
    (OBS, False, False),
    ((8, 8, 9), True, False),
    ((8, 8, 9), True, True),
]


@pytest.mark.parametrize("obs_dim,image,mem_eff", FLAT_MODES)
def test_flat_buffer_contract_matches_jax(obs_dim, image, mem_eff):
    kw = dict(max_replay_buffer_size=10, observation_dim=obs_dim, action_dim=ACT,
              image_buffer=image, memory_efficient_way=mem_eff)
    buf, ref = SimpleReplayBuffer(device="cpu", **kw), JaxSimpleReplayBuffer(**kw)
    assert buf.sampling_style == ref.sampling_style == "rng"
    assert buf.scannable == ref.scannable == (not mem_eff)


def test_slac_buffer_contract_matches_jax():
    kw = dict(capacity=10, num_sequences=NS, frame_shape=(8, 8, 3), action_dim=ACT)
    buf, ref = SlacReplayBuffer(device="cpu", **kw), JaxSlacReplayBuffer(**kw)
    assert buf.scannable is ref.scannable is True
    # the port draws from a torch.Generator where JAX takes a key
    assert (buf.sampling_style, ref.sampling_style) == ("generator", "key")


class _KeywordOnly:
    """A buffer whose ``random_batch`` takes its source of randomness by
    keyword only, and records it."""

    def __init__(self, style, batch):
        self.sampling_style, self.batch, self.seen = style, batch, []

    def random_batch(self, batch_size, *, generator=None, rng=None):
        self.seen.append((batch_size, generator, rng))
        return self.batch


class _StubTrainer:
    """Counts steps; its diagnostics are the last batch's reward mean."""

    def __init__(self, device="cpu"):
        self.device, self.steps, self.epochs, self.last = torch.device(device), 0, [], None

    def train(self, batch):
        self.steps += 1
        self.last = float(np.asarray(batch["rewards"]).mean())
        return {"loss": torch.tensor(self.last)}

    def get_diagnostics(self):
        return {"num train calls": float(self.steps), "reward": self.last}

    def end_epoch(self, epoch):
        self.epochs.append(epoch)


@pytest.mark.parametrize("style", ["generator", "rng"])
def test_loop_passes_its_randomness_by_keyword(style):
    buf = _KeywordOnly(style, {"rewards": np.ones((4, 1), np.float32)})
    tr = _StubTrainer()
    algo = SimpleOfflineRlAlgorithm(tr, buf, batch_size=4, num_epochs=2, num_batches_per_epoch=3,
                                    logger=Logger())
    algo.train()
    assert tr.steps == 6 and tr.epochs == [0, 1] and len(buf.seen) == 6
    size, gen, rng = buf.seen[0]
    assert size == 4
    if style == "generator":
        assert isinstance(gen, torch.Generator) and rng is None
    else:
        assert isinstance(rng, np.random.RandomState) and gen is None


def _flat_buffer(obs_dim, image, mem_eff, n=20, seed=0):
    rs = np.random.RandomState(seed)
    buf = SimpleReplayBuffer(n, obs_dim, ACT, image_buffer=image, memory_efficient_way=mem_eff,
                             device="cpu")
    shape = (obs_dim,) if np.isscalar(obs_dim) else obs_dim
    draw = ((lambda: rs.randint(0, 256, shape).astype(np.uint8)) if image  # noqa: E731
            else (lambda: rs.randn(*shape).astype(np.float32)))
    for _ in range(n):
        buf.add_sample(draw(), rs.uniform(-1, 1, ACT), rs.randn(), 0.0, draw())
    return buf


def test_loop_trains_each_buffer_kind_for_an_epoch(tmp_path):
    """The SLAC buffer with a CQL + SLAC trainer, the state buffer with a
    state CQL trainer, the image buffers (memory-efficient too) with a stub:
    one epoch each, a progress.csv row each."""
    slac = SlacAlgorithm(ACT, num_sequences=NS, buffer_size=300, batch_size_latent=2,
                         image_size=64, device="cpu", **SMALL)
    slac.buffer.ingest_real(dataset(seed=4))
    nets = lambda p, q: (TanhGaussianPolicy(p, (16,), ACT), CriticSLAC(q, ACT, (16,)))  # noqa: E731
    runs = [(CQLTrainer(*nets(slac.feature_action_dim, slac.z_dim), slac_algo=slac, num_random=2,
                        device="cpu"), slac.buffer),
            (CQLTrainer(*nets(OBS, OBS), num_random=2, device="cpu"),
             _flat_buffer(*FLAT_MODES[0]))]
    runs += [(_StubTrainer(), _flat_buffer(*mode)) for mode in FLAT_MODES[1:]]
    for i, (tr, buf) in enumerate(runs):
        log = Logger()
        log.set_log_dir(str(tmp_path / str(i)))
        SimpleOfflineRlAlgorithm(tr, buf, batch_size=4, num_epochs=1, num_batches_per_epoch=2,
                                 logger=log).train()
        log.close()
        with open(tmp_path / str(i) / "progress.csv") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 1 and rows[0]["epoch"] == "0"
        assert float(rows[0]["trainer/num train calls"]) == 2.0
        assert float(rows[0]["time/training"]) > 0.0
    assert slac.learning_steps_latent == 2


def test_progress_columns_match_jax(tmp_path, capsys):
    """The same stub trainer through both loops: the same progress.csv
    header, in the same order."""
    headers = []
    for algo_cls, log_cls, name in ((SimpleOfflineRlAlgorithm, Logger, "port"),
                                    (JaxSimpleOfflineRlAlgorithm, JaxLogger, "jax")):
        log = log_cls()
        log.set_log_dir(str(tmp_path / name))
        buf = _KeywordOnly("rng", {"rewards": np.zeros((2, 1), np.float32)})
        algo_cls(_StubTrainer(), buf, batch_size=2, num_epochs=2, num_batches_per_epoch=1,
                 logger=log).train()
        log.close()
        with open(tmp_path / name / "progress.csv") as f:
            headers.append(next(csv.reader(f)))
    assert headers[0] == headers[1]


@pytest.mark.parametrize("mode,gap,written", [
    ("all", 10, ["itr_0.pkl", "itr_1.pkl", "itr_2.pkl", "itr_3.pkl"]),
    ("last", 10, ["params.pkl"]),
    ("gap", 2, ["itr_0.pkl", "itr_2.pkl"]),
    ("gap_and_last", 3, ["itr_0.pkl", "itr_3.pkl", "params.pkl"]),
    ("none", 1, []),
])
def test_snapshot_modes_match_jax(tmp_path, mode, gap, written):
    """``save_itr_params`` writes the files JAX's logger writes, as numpy
    trees (tensors converted) that load without torch."""
    for log_cls, name in ((Logger, "port"), (JaxLogger, "jax")):
        log = log_cls()
        log.set_log_dir(str(tmp_path / name))
        log.set_snapshot_mode(mode)
        log.set_snapshot_gap(gap)
        for itr in range(4):
            log.save_itr_params(itr, {"w": torch.full((2,), float(itr)) if name == "port"
                                      else np.full((2,), float(itr), np.float32), "itr": itr})
        log.close()
        files = sorted(f for f in os.listdir(tmp_path / name) if f.endswith(".pkl"))
        assert files == written, name
    if written:
        with open(tmp_path / "port" / written[-1], "rb") as f:
            snap = pickle.load(f)
        assert isinstance(snap["w"], np.ndarray) and snap["w"][0] == snap["itr"]
    with pytest.raises(ValueError):
        Logger().set_snapshot_mode("every")
    with pytest.raises(ValueError):
        Logger().set_snapshot_gap(0)
    assert Logger().save_itr_params(0, {}) is None  # no log dir
    assert isinstance(logger, Logger)


def test_timers():
    pt = PhaseTimer()
    with pt.phase("training"):
        sum(range(1000))
    pt.stamp("logging", sync={"m": [torch.ones(2)]})
    cols = pt.end_epoch()
    assert list(cols) == ["time/training (s)", "time/logging (s)", "time/epoch (s)",
                          "time/total (s)"]
    assert all(v >= 0 for v in cols.values()) and set(pt.totals()) == {"training", "logging"}
    assert list(pt.end_epoch()) == ["time/epoch (s)", "time/total (s)"]
    t = Timer(return_global_times=True)
    t.start_timer("a")
    with pytest.raises(RuntimeError):
        t.start_timer("a")
    assert t.stop_timer("a") >= 0
    assert set(t.get_times()) == {"a", "epoch_time", "global/a", "global/total_time"}
    t.start_epoch()
    assert set(t.get_times()) == {"epoch_time", "global/a", "global/total_time"}
    block_until_ready(None)


class _Point(Serializable):
    def __init__(self, x, y=2):
        self.quick_init(locals())
        self.x, self.y = x, y


def test_trainer_protocols_and_serializable():
    with pytest.raises(TypeError):
        Trainer()
    with pytest.raises(TypeError):
        LossFunction()

    class Noop(Trainer):
        def train(self, data):
            return data

    t = Noop()
    assert t.train(1) == 1 and t.get_snapshot() == {} and t.get_diagnostics() == {}
    p = pickle.loads(pickle.dumps(_Point(1, y=5)))
    assert (p.x, p.y) == (1, 5)
    q = _Point.clone(p, y=7)
    assert (q.x, q.y) == (1, 7)
