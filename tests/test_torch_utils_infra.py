"""The port's experiment utilities against the JAX package's: the cases of
tests/test_pyutil.py, test_launcher_plot.py and test_utils_aux.py (those of
modules the port has: pyutil, the launcher, io, plotting, exploration,
sweeps and schedules, the golden-tensor trace), each held to JAX's output
where there is one; and the port's own pieces: ``RngStream``, profiling,
``run_parallel_seeds`` under ``spawn``, the logger's prefixes, table
printer and extra data."""

import json
import os
import os.path as osp
import pickle
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2p_tpu.envs import StubEnv as JaxStubEnv
from s2p_tpu.testing import TensorTrace as JaxTensorTrace
from s2p_tpu.utils import exploration as jexp
from s2p_tpu.utils import plotting as jplot
from s2p_tpu.utils import pyutil as jpy
from s2p_tpu.utils import sweep as jsweep
from s2p_tpu.utils.logging import Logger as JaxLogger
from s2p_tpu.utils.logging import TerminalTablePrinter as JaxTablePrinter
from s2p_tpu.utils.seeding import _stable_hash as jax_stable_hash
from s2p_tpu_torch.envs import StubEnv
from s2p_tpu_torch.testing import StubPolicy, TensorTrace
from s2p_tpu_torch.utils import exploration, plotting, pyutil, sweep
from s2p_tpu_torch.utils.io import load_local_or_remote_file, save_pickle
from s2p_tpu_torch.utils.launcher import run_experiment, run_parallel_seeds
from s2p_tpu_torch.utils.logging import Logger, TerminalTablePrinter
from s2p_tpu_torch.utils.profiling import annotate, time_compiled_fn, trace
from s2p_tpu_torch.utils.seeding import RngStream, _stable_hash


# -- pyutil (tests/test_pyutil.py) -------------------------------------------

def test_dot_map_roundtrip():
    nested = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    flat = pyutil.nested_dict_to_dot_map_dict(nested)
    assert flat == {"a.b": 1, "a.c.d": 2, "e": 3} == jpy.nested_dict_to_dot_map_dict(nested)
    assert pyutil.dot_map_dict_to_nested_dict(flat) == nested
    with pytest.raises(ValueError, match="path conflict"):
        pyutil.dot_map_dict_to_nested_dict({"a": 1, "a.b": 2})


def test_merge_recursive():
    a = {"x": {"y": 1}}
    pyutil.merge_recursive_dicts(a, {"x": {"z": 2}, "w": 3})
    assert a == {"x": {"y": 1, "z": 2}, "w": 3}
    with pytest.raises(KeyError):
        pyutil.merge_recursive_dicts({"k": 1}, {"k": 2})
    merged = pyutil.merge_recursive_dicts({"k": 1}, {"k": 2},
                                          ignore_duplicate_keys_in_second_dict=True)
    assert merged["k"] == 1


def test_dict_list_conversions():
    d = {"a": [1, 2], "b": [3, 4]}
    lst = pyutil.dict_of_list__to__list_of_dicts(d, 2)
    assert lst == [{"a": 1, "b": 3}, {"a": 2, "b": 4}] == jpy.dict_of_list__to__list_of_dicts(d, 2)
    assert pyutil.list_of_dicts__to__dict_of_lists(lst) == d
    with pytest.raises(ValueError, match="inconsistent keys"):
        pyutil.list_of_dicts__to__dict_of_lists([{"a": 1}, {"b": 2}])


def test_safe_json():
    assert pyutil.safe_json({"a": [1, 2.5, "x", None]})
    assert not pyutil.safe_json({"a": object()})
    data = {"a": object(), "b": {"c": 1}, "d": (1, 2)}
    out = pyutil.dict_to_safe_json(data)
    assert isinstance(out["a"], str) and out["b"] == {"c": 1}
    assert {k: v for k, v in out.items() if k != "a"} == {
        k: v for k, v in jpy.dict_to_safe_json(data).items() if k != "a"}


def test_treemap():
    t = {"a": [1, 2], "b": 3}
    assert pyutil.treemap(lambda x: x * 2, t) == {"a": [2, 4], "b": 6}
    assert pyutil.treemap(lambda x, y: x + y, t, t) == jpy.treemap(lambda x, y: x + y, t, t)


# -- launcher, io, plotting (tests/test_launcher_plot.py) --------------------

def record_seed(variant):
    """The experiment of the launcher tests: importable, for ``spawn``."""
    from s2p_tpu_torch.utils.logging import logger

    logger.record_tabular("seed", variant["seed"])
    logger.dump_tabular()
    return "done"


def test_run_experiment_here_artifacts(tmp_path):
    out = run_experiment(record_seed, {"a": 1}, exp_name="t", seed=3,
                         base_log_dir=str(tmp_path))
    assert out == "done"
    (run_dir,) = list((tmp_path / "t").iterdir())
    files = {p.name for p in run_dir.iterdir()}
    assert {"variant.json", "experiment.pkl", "debug.log", "progress.csv"} <= files
    exp = load_local_or_remote_file(str(run_dir / "experiment.pkl"))
    assert exp["seed"] == 3 and exp["variant"]["a"] == 1
    assert json.loads((run_dir / "variant.json").read_text())["exp_name"] == "t"
    assert (run_dir / "progress.csv").read_text().splitlines() == ["seed", "3"]
    with pytest.raises(ValueError, match="not supported"):
        run_experiment(record_seed, {}, mode="ec2")


def test_run_parallel_seeds_under_spawn(tmp_path):
    procs = run_parallel_seeds(record_seed, {"a": 1}, seeds=[0, 1], exp_name="p",
                               base_log_dir=str(tmp_path), stagger_seconds=0)
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
    rows = sorted((d / "progress.csv").read_text().splitlines()[1]
                  for d in (tmp_path / "p").iterdir())
    assert rows == ["0", "1"]


def test_io_roundtrip(tmp_path):
    p = str(tmp_path / "x.pkl")
    save_pickle({"k": np.arange(3)}, p)
    np.testing.assert_array_equal(load_local_or_remote_file(p)["k"], np.arange(3))
    npy = str(tmp_path / "y.npy")
    np.save(npy, np.ones(4))
    np.testing.assert_array_equal(load_local_or_remote_file(npy), np.ones(4))
    pt = str(tmp_path / "z.pth")
    torch.save({"w": torch.arange(2)}, pt)
    assert torch.equal(load_local_or_remote_file(pt)["w"], torch.arange(2))


def test_plotting(tmp_path):
    for seed, vals in ((0, "1.0 2.0 3.0"), (1, "2.0 3.0 4.0")):
        run = tmp_path / "exp" / f"run_s{seed}"
        run.mkdir(parents=True)
        (run / "progress.csv").write_text("epoch,eval/Average Returns\n" + "".join(
            f"{i},{v}\n" for i, v in enumerate(vals.split())))
        (run / "variant.json").write_text(json.dumps({"seed": seed}))
    exps, jexps = plotting.load_exps(str(tmp_path)), jplot.load_exps(str(tmp_path))
    assert len(exps) == 2
    for e, je in zip(exps, jexps):
        np.testing.assert_array_equal(e.column("eval/Average Returns"),
                                      je.column("eval/Average Returns"))
        assert e.variant == je.variant
    assert [e.variant["seed"] for e in plotting.filter_exps(exps, lambda v: v["seed"] == 1)] == [1]
    y = np.array([1.0, 2, 3, 5])
    np.testing.assert_array_equal(plotting.smooth(y, 2), jplot.smooth(y, 2))
    out = str(tmp_path / "plot.png")
    ax = plotting.plot_returns(exps, save_path=out, label="runs")
    assert osp.getsize(out) > 0
    np.testing.assert_allclose(ax.lines[0].get_ydata(), [1.5, 2.5, 3.5])


# -- exploration, sweeps, schedules, traces (tests/test_utils_aux.py) --------

def test_exploration_strategies_match_jax():
    env, jenv = StubEnv(obs_dim=3, action_dim=2), JaxStubEnv(obs_dim=3, action_dim=2)
    pol = StubPolicy(np.zeros(2))
    eg = exploration.EpsilonGreedy(env.action_space, prob_random_action=1.0)
    a, _ = eg.get_action(0, np.zeros(3), pol)
    assert env.action_space.contains(a)

    for cls, kw in ((exploration.GaussianStrategy, dict(max_sigma=0.1, min_sigma=0.01,
                                                        decay_period=4)),
                    (exploration.OUStrategy, dict(max_sigma=0.1, decay_period=4)),
                    (exploration.GaussianAndEpsilonStrategy, dict(epsilon=0.0, max_sigma=0.1))):
        ours = cls(env.action_space, seed=5, **kw)
        ref = getattr(jexp, cls.__name__)(jenv.action_space, seed=5, **kw)
        got = [ours.get_action_from_raw_action(np.full(2, 0.5), t=t) for t in range(6)]
        want = [ref.get_action_from_raw_action(np.full(2, 0.5), t=t) for t in range(6)]
        np.testing.assert_array_equal(got, want, err_msg=cls.__name__)
        assert not np.array_equal(got[0], got[1])  # the noise evolves
        assert (np.abs(got) <= 1.0).all()

    gs = exploration.GaussianStrategy(env.action_space, max_sigma=0.1, min_sigma=0.1)
    wrapped = exploration.PolicyWrappedWithExplorationStrategy(gs, pol)
    a, _ = wrapped.get_action(np.zeros(3))
    assert wrapped.t == 1 and a.shape == (2,)
    wrapped.reset()
    assert wrapped.t == 0


def test_sweepers_match_jax():
    grid_kw = dict(hyperparameters={"trainer_kwargs.lr": [1e-3, 1e-4], "seed": [0, 1, 2]},
                   default_parameters={"trainer_kwargs": {"discount": 0.99}})
    variants = sweep.DeterministicHyperparameterSweeper(**grid_kw).iterate_hyperparameters()
    ref = jsweep.DeterministicHyperparameterSweeper(**grid_kw).iterate_hyperparameters()
    assert len(variants) == 6 and variants[0].trainer_kwargs.discount == 0.99
    assert [v.to_dict() for v in variants] == [v.to_dict() for v in ref]

    draws = []
    for mod in (sweep, jsweep):
        random.seed(7)
        params = [mod.LogFloatParam("lr", 1e-5, 1e-2), mod.LinearIntParam("n", 1, 9),
                  mod.EnumParam("act", ["relu", "tanh"]), mod.LogIntParam("h", 8, 512),
                  mod.LinearFloatParam("tau", 0.0, 1.0)]
        rand = mod.RandomHyperparameterSweeper(params, default_kwargs={"seed": 0})
        draws.append([v.to_dict() for v in rand.iterate_hyperparameters(5)])
    assert draws[0] == draws[1] and all(1e-5 <= v["lr"] <= 1e-2 for v in draws[0])
    with pytest.raises(ValueError, match="duplicate"):
        sweep.RandomHyperparameterSweeper([sweep.LinearIntParam("n", 0, 1)] * 2)


def test_schedules_match_jax():
    pairs = [(sweep.ConstantSchedule(3.0), jsweep.ConstantSchedule(3.0)),
             (sweep.LinearSchedule(0.0, 10.0, ramp_duration=10),
              jsweep.LinearSchedule(0.0, 10.0, ramp_duration=10)),
             (sweep.IntLinearSchedule(0.0, 10.0, 4, start=2),
              jsweep.IntLinearSchedule(0.0, 10.0, 4, start=2)),
             (sweep.PiecewiseLinearSchedule([0, 10, 20], [1.0, 0.5, 0.0]),
              jsweep.PiecewiseLinearSchedule([0, 10, 20], [1.0, 0.5, 0.0])),
             (sweep.IntPiecewiseLinearSchedule([0, 10], [0, 7]),
              jsweep.IntPiecewiseLinearSchedule([0, 10], [0, 7]))]
    for ours, ref in pairs:
        assert [ours.get_value(t) for t in (0, 3, 5, 15, 100)] == [
            ref.get_value(t) for t in (0, 3, 5, 15, 100)]
    assert sweep.LinearSchedule(0.0, 10.0, ramp_duration=10).get_value(5) == 5.0
    assert sweep.PiecewiseLinearSchedule([0, 10, 20], [1.0, 0.5, 0.0]).get_value(15) == \
        pytest.approx(0.25)


def test_tensor_trace(tmp_path):
    t1, t2 = TensorTrace(str(tmp_path / "a")), TensorTrace(str(tmp_path / "b"))
    for i in range(3):
        x = np.full((2, 2), i, np.float32)
        t1.save(x)
        t2.save(torch.from_numpy(x))
    t1.compare(t2)
    # the port's files read in the JAX package's trace, and the other way
    jt = JaxTensorTrace(str(tmp_path / "c"))
    for i in range(3):
        jt.save(jnp.full((2, 2), i, jnp.float32))
    np.testing.assert_array_equal(t1.load(2), jt.load(2))
    t3 = TensorTrace(str(tmp_path / "d"))
    for i in range(3):
        t3.save(np.full((2, 2), i + (i == 1), np.float32))
    with pytest.raises(AssertionError, match="trace idx 1"):
        t1.compare(t3)


# -- the port's own: RngStream, profiling, the logger ------------------------

def test_rng_stream_is_reproducible_and_independent():
    assert _stable_hash("policy") == jax_stable_hash("policy")
    draw = lambda g: torch.rand(4, generator=g)
    a, b = RngStream(0), RngStream(0)
    first = [draw(a.next("init")), draw(a.next("init")), draw(a.next("sample"))]
    again = [draw(b.next("init")), draw(b.next("init")), draw(b.next("sample"))]
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert not torch.equal(first[0], first[1]) and not torch.equal(first[0], first[2])
    assert not torch.equal(first[0], draw(RngStream(1).next("init")))
    assert a.state() == {"init": 2, "sample": 1}
    c = RngStream(0)
    c.restore({"init": 1})
    assert torch.equal(draw(c.next("init")), first[1])
    gens = RngStream(0).next_n(3, "split")
    outs = [draw(g) for g in gens]
    assert len(outs) == 3 and not torch.equal(outs[0], outs[1])
    assert all(torch.equal(x, draw(g)) for x, g in zip(outs, RngStream(0).next_n(3, "split")))


def test_profiling_trace_annotate_and_timing(tmp_path):
    with trace(str(tmp_path / "prof")):
        with annotate("matmul_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul_region" for e in events)
    stats = time_compiled_fn(lambda x: x @ x, torch.ones(32, 32), iters=3, device="cpu")
    assert set(stats) == {"compile_s", "steady_s_per_call", "calls_per_s"}
    assert stats["steady_s_per_call"] > 0 and stats["compile_s"] > 0


def test_time_compiled_fn_on_the_card_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        time_compiled_fn(lambda: None)


def test_logger_prefixes_table_and_extra_data_match_jax(tmp_path, capsys):
    logs = []
    for cls, name in ((Logger, "ours"), (JaxLogger, "jax")):
        log = cls()
        log.set_log_dir(str(tmp_path / name))
        log.push_prefix("eval/")
        log.push_prefix("env0 ")
        log.record_tabular("return", 1.5)
        log.pop_prefix()
        log.record_tabular("len", 3)
        log.pop_prefix()
        log.record_tabular("epoch", 0)
        log.set_print_tabular(False)
        log.dump_tabular()
        log.save_extra_data({"a": [1, 2]}, "extra.json")
        log.save_extra_data({"w": np.arange(3)}, "extra.pkl")
        log.close()
        logs.append(tmp_path / name)
    assert capsys.readouterr().out == ""  # the table is not printed
    ours, ref = ((d / "progress.csv").read_text() for d in logs)
    assert ours == ref and ours.splitlines()[0] == "eval/env0 return,eval/len,epoch"
    assert json.loads((logs[0] / "extra.json").read_text()) == {"a": [1, 2]}
    with open(logs[0] / "extra.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["w"], np.arange(3))
    rows = [("epoch", 3), ("eval/return", 1.25)]
    assert TerminalTablePrinter.format(rows) == JaxTablePrinter.format(rows)
    assert TerminalTablePrinter.format([]) == ""
    assert os.path.exists(logs[0] / "debug.log")
