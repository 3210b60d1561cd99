"""The IQL + SLAC cell at a tiny size on the CPU: the reference's shapes,
windows and FLOP count against the port and the flop counter, a sound run
correct, and the controls and the broken timed paths not correct.

Tiny: 64px frames (the smaller of SLAC's two encoder chains), batch 4 of
8-step windows, latent heads and the IQL nets 16 wide, feature 16, z 4 + 8;
two episodes of 20 rows in each dataset. The program runs in float32, as
the cell does, so a sound run's readings sit far below the cell's limits.
"""

import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import PARKED
from portbench import harness, trace
from portbench.counts import slac_iql as counts
from portbench.reference import slac_iql as ref
from portbench.reference.precision import Precision

CPU = torch.device("cpu")
CELL = "slac-iql-100-b128"
# the cell's entries, ready for BENCHMARK.json (PERF.md, Open questions: parked for its spread)
END_TO_END = {"name": "train_steps_per_s", "unit": "steps/s", "better": "higher",
              "source": "host_clock", "workloads": [CELL]}
PER_LAYER = [
    {"name": "launches_per_step.slac_iql", "unit": "launches/step", "better": "lower",
     "source": "device_trace", "layer": "host glue", "moves": "train_steps_per_s",
     "workloads": [CELL]},
    {"name": "syncs_per_step.slac_iql", "unit": "syncs/step", "better": "lower",
     "source": "device_trace", "layer": "host glue", "moves": "train_steps_per_s",
     "workloads": [CELL]},
    {"name": "mfu.slac_iql", "unit": "%", "better": "higher", "source": "device_trace",
     "layer": "whole step", "moves": "train_steps_per_s", "workloads": [CELL]},
    {"name": "idle_share.slac_iql", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "train_steps_per_s", "workloads": [CELL]},
]


def parked_cell() -> harness.Cell:
    cell = harness.load_cell(CELL, entry=PARKED[CELL])
    cell.end_to_end.append(END_TO_END)
    cell.per_layer = list(PER_LAYER)
    return cell
TINY_SLAC = dict(feature_dim=16, z1_dim=4, z2_dim=8, hidden_units=[16, 16], batch_size_latent=2)
TINY_IQL = dict(policy_hidden=[16, 16], critic_hidden=[16, 16])
TINY_TRAFFIC = dict(batch=4, real_rows=40, gen_rows=40, episode_len=20, warmup_calls=1,
                    trace_calls=2)


def tiny_cell() -> harness.Cell:
    cell = parked_cell()
    cfg = cell.config
    cell.config = dict(cfg, image_size=64, buffer_size=200, slac=dict(cfg["slac"], **TINY_SLAC),
                       iql=dict(cfg["iql"], **TINY_IQL))
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    return cell


def run(cell, seed=2**40 + 7):
    return harness.run_cell(cell, seed, 0.3, False, CPU, time.perf_counter())


def judged(cell, seed):
    ctx = harness.Ctx(cell, seed, CPU)
    return ctx, cell.driver.setup(ctx).finish()


def test_specs_are_the_ports_parameters():
    from s2p_tpu_torch.rl import CriticSLAC, TanhGaussianPolicy
    from s2p_tpu_torch.slac import SlacAlgorithm

    for cfg in (parked_cell().config, tiny_cell().config):
        s, q, A = cfg["slac"], cfg["iql"], cfg["action_dim"]
        slac = SlacAlgorithm(A, buffer_size=10, feature_dim=s["feature_dim"], z1_dim=s["z1_dim"],
                             z2_dim=s["z2_dim"], hidden_units=tuple(s["hidden_units"]),
                             image_size=cfg["image_size"], device="cpu")
        nets = {"latent": slac.latent,
                "critic": CriticSLAC(slac.z_dim, A, tuple(q["critic_hidden"])),
                "policy": TanhGaussianPolicy(slac.feature_action_dim, tuple(q["policy_hidden"]), A)}
        for name, spec in (("latent", ref.latent_spec(cfg)), ("critic", ref.critic_spec(cfg)),
                           ("policy", ref.policy_spec(cfg))):
            assert {k: tuple(p.shape) for k, p in nets[name].named_parameters()} == spec, name


def test_reference_windows_are_the_buffers_slots():
    """Every slot the port's ingestion makes, against the reference's window
    built from the raw datasets: frames, actions and rewards."""
    cell = tiny_cell()
    ctx = harness.Ctx(cell, 5, CPU)
    prog = cell.driver.setup(ctx)
    buf = prog.slac.buffer
    table = ref.windows(*prog.datasets, cell.config["num_sequences"],
                        cell.traffic["uncertainty_lambda"])
    idx = torch.arange(len(buf))
    assert len(table["frames"]) == len(buf) == 25 + 23 and buf.real_n == 25
    x, a, r, d = buf.gather(idx)
    rx, ra, rr, rd = ref.gather(table, idx, CPU, torch.float32)
    torch.testing.assert_close(x, rx, rtol=0, atol=1e-7)  # x/255 against x·f32(1/255)
    assert torch.equal(a, ra) and torch.equal(d, rd)
    torch.testing.assert_close(r, rr, rtol=1e-6, atol=1e-6)  # the penalty in float64, then f32


def test_sound_run_is_correct_and_close():
    """Float32 on both sides on the CPU: the losses agree to rounding (1e-5);
    the gradients to 1e-4 of a leaf's norm (the same products summed in
    another order, and the AWR weights exp((Q − V)/β) scale the rounding of
    Q and V by 1/β = 10); the change after three Adam steps moves by
    lr·m/√v, where a gradient element at rounding level may flip its sign:
    1e-2."""
    res = run(tiny_cell())
    assert res["correct"], res["checks"]
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["loss_gap"] < 1e-5 and checks["grad_gap"] < 1e-4, checks
    assert checks["change_gap"] < 1e-2, checks
    assert list(res)[-1] == "checks" and res["metrics"]["train_steps_per_s"]["value"] > 0


@pytest.mark.parametrize("kind", ["bf16", "half_batch"])
def test_control_fails(kind):
    cell = tiny_cell()
    ctx, j = judged(cell, 13)
    readings = cell.driver.control(ctx, j, kind)
    assert not harness.judge(readings, cell.limits), readings


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_fails(fault, monkeypatch):
    from s2p_tpu_torch.rl import IQLTrainer

    train = IQLTrainer.train
    if fault == "unchanged":  # the optimizers leave the parameters as they were
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":  # the step takes the mean over the first half of its rows
        def half(self, batch, prepare_noise=None, latent_draws=None):
            cut = lambda t: t[:len(t) // 2]  # noqa: E731
            if latent_draws is not None:
                latent_draws = (cut(latent_draws[0]), [cut(t) for t in latent_draws[1]])
            return train(self, {k: cut(v) for k, v in batch.items()},
                         None if prepare_noise is None else [cut(t) for t in prepare_noise],
                         latent_draws)
        monkeypatch.setattr(IQLTrainer, "train", half)
    else:  # the step's answer, one trained leaf, altered where it is produced
        def altered(self, *args, **kw):
            m = train(self, *args, **kw)
            with torch.no_grad():
                self.policy.fc1.weight.mul_(1.5)
            return m
        monkeypatch.setattr(IQLTrainer, "train", altered)
    res = run(tiny_cell())
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("size", [64, 100])
def test_flops_match_the_flop_counter(size):
    """One step of the reference under the flop counter: its convolutions,
    transposed convolutions and matrix products, forward and backward."""
    cell = tiny_cell()
    cfg = dict(cell.config, image_size=size)
    ctx = harness.Ctx(cell, 3, CPU)
    ctx.cell.config = cfg
    g = torch.Generator().manual_seed(4)
    W = {m: harness.seeded_weights(spec, g, CPU) for m, spec in (
        ("latent", ref.latent_spec(cfg)), ("critic", ref.critic_spec(cfg)),
        ("policy", ref.policy_spec(cfg)))}
    S, A, B, Bl = cfg["num_sequences"], cfg["action_dim"], 3, 2
    s = cfg["slac"]

    def window(b):
        return (torch.rand(b, S + 1, size, size, 3, generator=g),
                torch.rand(b, S, A, generator=g) * 2 - 1, torch.randn(b, S, 1, generator=g),
                torch.zeros(b, S, 1))

    def noise(b):
        return [torch.randn(b, d, generator=g) for _ in range(S + 1)
                for d in (s["z1_dim"], s["z2_dim"])]

    step = dict(batch=window(B), noise=noise(B), latent=window(Bl), latent_noise=noise(Bl))
    with FlopCounterMode(display=False) as counter:
        ref.train_steps(cfg, W, [step], Precision("f32"))
    assert counts.train_step(cfg, dict(batch=B)) == counter.get_total_flops()


def test_full_size_count():
    """The step's FLOPs at the cell's shapes (the figures PERF.md quotes)."""
    cfg = parked_cell().config
    assert sum(counts.encoder(cfg, 1)) == 109_832_960  # one 100px frame
    assert counts.train_step(cfg, dict(batch=128)) == 321_373_429_760


def test_readers_on_a_trace():
    def ev(cat, name, ts, dur, **args):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
        return dict(e, args=args) if args else e

    doc = {"traceEvents": [
        ev("user_annotation", "portbench.window", 0.0, 100.0),
        ev("kernel", "k", 10.0, 30.0, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 5.0, 1.0, correlation=1),
        ev("cuda_runtime", "cudaDeviceSynchronize", 90.0, 5.0)]}
    from portbench import spans

    summary = dict(trace.summarize(doc, "portbench.window"),
                   spans=spans.summarize(doc, "portbench.window"))
    cfg = parked_cell().config
    rec = dict(trace=summary, window_s=summary["window_s"], units={"steps": 2}, config=cfg,
               traffic={"batch": 128})
    read = lambda name: harness.load_module(  # noqa: E731
        harness.BENCH / "metrics" / f"{name}.py").read(rec)
    assert read("idle_share.slac_iql") == pytest.approx(70.0)
    assert read("launches_per_step.slac_iql") == 0.5
    assert read("syncs_per_step.slac_iql") == 0.5
    assert read("mfu.slac_iql") == pytest.approx(
        100 * 2 * counts.train_step(cfg, {"batch": 128}) / (100e-6 * 494.7e12))
    for name in ("idle_share.slac_iql", "launches_per_step.slac_iql", "syncs_per_step.slac_iql"):
        assert harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(
            dict(rec, trace=None)) is None, name


def test_windows_leave_out_partial_and_last_rows():
    """The windows' edges on a hand-made pair of datasets of one 12-row
    episode each (S = 8): 4 real windows (the timeout row dropped), 3
    generated (rows 8…10)."""
    S, n = 8, 12
    frames = np.arange(n, dtype=np.uint8)[:, None, None, None] * np.ones((1, 2, 2, 3), np.uint8)
    timeouts = np.zeros(n, np.float32)
    timeouts[-1] = 1
    real = dict(image_observations=frames, image_observations_tp1=frames + 100,
                actions=np.ones((n, 6), np.float32), rewards=np.arange(n, dtype=np.float32),
                timeouts=timeouts)
    obs = np.arange(n)[:, None] - S + np.arange(S + 1)[None]
    obs[:S] = ref.SENTINEL
    gen = dict(image_observations=frames, image_observations_tp1=frames + 200,
               actions=np.zeros((n, 6), np.float32), rewards=np.full(n, 5.0, np.float32),
               original_actions=np.ones((n, 6), np.float32),
               original_rewards=np.arange(n, dtype=np.float32),
               aleatoric_uncertainty=np.full(n, 0.5, np.float32), timeouts=timeouts,
               slac_observation_indices=obs, slac_action_indices=obs[:, :-1])
    t = ref.windows(real, gen, S, penalty=2.0)
    assert len(t["frames"]) == 4 + 3
    first = t["pool"][t["frames"][0]][:, 0, 0, 0]
    assert list(first) == [0, 100, 101, 102, 103, 104, 105, 106, 107]
    last_gen = t["pool"][t["frames"][-1]][:, 0, 0, 0]
    assert list(last_gen) == [2, 3, 4, 5, 6, 7, 8, 9, 209]  # row 10: rows 2…9, row 9's frame
    assert list(t["rewards"][-1]) == [2, 3, 4, 5, 6, 7, 8, 4.0]  # 5 − 2 · 0.5


def test_entries_keep_the_contract():
    """The parked entries as BENCHMARK.json would take them: a reader each,
    each per-layer metric moving the cell's end-to-end metric."""
    assert set(END_TO_END) == {"name", "unit", "better", "source", "workloads"}
    for m in PER_LAYER:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == END_TO_END["name"]
    for m in [END_TO_END, *PER_LAYER]:
        assert hasattr(harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py"), "read")
