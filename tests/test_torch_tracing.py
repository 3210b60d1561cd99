"""The port's spans and the benchmark's reduction of them, on the CPU.

The port marks its layer boundaries with ``utils.profiling.annotate``: a
``record_function`` range while a profiler records, one shared null context
otherwise. ``portbench/spans.py`` reduces a Chrome trace to one row per
``s2p.*`` span name; its readers give the span metrics."""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans, trace
from portbench.counts import mat_norm
from s2p_tpu_torch.cli.generate_images import generate_images_for_dataset
from s2p_tpu_torch.gan import GANLossConfig, GANTrainer, S2PGenerator, generate_rollout_fast
from s2p_tpu_torch.utils import profiling

PORT = Path(__file__).resolve().parents[1] / "s2p_tpu_torch"
CFG = dict(state_dim=3, image_size=32, ngf=8, n_up=4, state_freqs=2, state_embed_dim=16,
           mat_hidden=8, out_channels=3)
GEN_KEYS = ("image_size", "ngf", "n_up", "state_freqs", "state_embed_dim", "mat_hidden")


def tiny_generator(seed=0):
    return S2PGenerator(CFG["state_dim"], device="cpu", seed=seed,
                        **{k: CFG[k] for k in GEN_KEYS}).requires_grad_(False)


def rollout_inputs(T=2, B=2):
    g = torch.Generator().manual_seed(0)
    H = CFG["image_size"]
    return (torch.rand(B, H, H, 3, generator=g) * 2 - 1,
            torch.randn(T, B, CFG["state_dim"], generator=g))


def spans_of(prof) -> list:
    """The ``s2p.*`` ranges a finished profiler recorded, as (name, start, end)."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(spans.PREFIX)]


def counts(recorded) -> dict:
    out = {}
    for name, _, _ in recorded:
        out[name] = out.get(name, 0) + 1
    return out


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# -- annotate -----------------------------------------------------------------

def test_annotate_is_one_null_context_unless_a_profiler_records():
    off = profiling.annotate("s2p.a")
    assert off is profiling.annotate("s2p.b") and isinstance(off, contextlib.nullcontext)
    with cpu_profile():
        on = profiling.annotate("s2p.a")
        assert on is not off and not isinstance(on, contextlib.nullcontext)
    assert profiling.annotate("s2p.a") is off


def test_no_profiler_call_runs_in_the_port_without_a_profiler(monkeypatch):
    """With nothing recording, the generator (both paths), the bridge and a
    train step make no ``record_function`` and no NVTX call, and no module of
    the port but ``utils/profiling.py`` names either."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler call ran with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", refuse)
    gen = tiny_generator()
    init, states = rollout_inputs()
    generate_rollout_fast(gen, init, states)
    with torch.no_grad():
        gen(states[0], init)
    generate_images_for_dataset(bridge_rows(3), gen, batch_size=2)
    tiny_trainer().train_step(train_batch())
    named = [p.relative_to(PORT).as_posix() for p in sorted(PORT.rglob("*.py"))
             if "record_function" in p.read_text() or "nvtx" in p.read_text()]
    assert named == ["utils/profiling.py"]


# -- the spans the port records ------------------------------------------------

def test_fast_rollout_spans_and_frames():
    gen = tiny_generator()
    init, states = rollout_inputs(T=2)
    plain = generate_rollout_fast(gen, init, states)
    with cpu_profile() as prof:
        traced = generate_rollout_fast(gen, init, states)
    assert torch.equal(plain, traced)
    recorded = spans_of(prof)
    n = counts(recorded)
    blocks = CFG["n_up"] + 1
    assert n["s2p.gen.forward"] == 2 and n["s2p.fast.fuse"] == 1
    assert n["s2p.mat.norm"] == 2 * mat_norm.launches(CFG) == n["s2p.mat.gb"]
    assert n["s2p.fast.cmap"] == n["s2p.mat.hidden"] == 2 * blocks  # one per block and pass
    assert all(n[f"s2p.gen.block_{i}"] == 2 for i in range(blocks))
    assert n["s2p.gen.encode"] == n["s2p.gen.embed"] == n["s2p.gen.head"] == 2
    assert n["s2p.gen.upsample"] == 2 * (blocks - 1)
    # each constant-map assembly nests in a hidden map's span
    hidden = [(a, b) for name, a, b in recorded if name == "s2p.mat.hidden"]
    for name, a, b in recorded:
        if name == "s2p.fast.cmap":
            assert any(ha <= a and b <= hb for ha, hb in hidden)


def test_module_path_records_one_cond_per_norm_and_pass():
    gen = tiny_generator()
    init, states = rollout_inputs(T=1)
    with torch.no_grad():
        plain = gen(states[0], init)
        with cpu_profile() as prof:
            traced = gen(states[0], init)
    assert torch.equal(plain, traced)
    n = counts(spans_of(prof))
    norms = mat_norm.launches(CFG)
    assert n["s2p.gen.forward"] == 1
    assert n["s2p.mat.cond"] == n["s2p.mat.hidden"] == norms
    assert n["s2p.mat.gb"] == n["s2p.mat.norm"] == norms
    assert "s2p.fast.cmap" not in n


def bridge_rows(n: int, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    H = CFG["image_size"]
    return dict(image_observations=rs.randint(0, 256, (n, H, H, 3), dtype=np.uint8),
                next_observations=rs.randn(n, CFG["state_dim"]).astype(np.float32))


def test_bridge_spans_and_frames():
    gen, rows = tiny_generator(), bridge_rows(5)
    plain = generate_images_for_dataset(rows, gen, batch_size=2)
    with cpu_profile() as prof:
        traced = generate_images_for_dataset(rows, gen, batch_size=2)
    np.testing.assert_array_equal(plain, traced)
    n = counts(spans_of(prof))
    assert n["s2p.gen.forward"] == n["s2p.bridge.stage"] == n["s2p.bridge.d2h"] == 3
    assert "s2p.bridge.sync" not in n  # only a card is synchronised
    # a 'mat' generator renders on the fast path: operands fused once a call,
    # one constant-map assembly and one hidden conv per block a pass, no concat
    blocks = len(gen.sizes)
    assert n["s2p.fast.fuse"] == 1
    assert n["s2p.fast.cmap"] == n["s2p.mat.hidden"] == blocks * 3
    assert "s2p.mat.cond" not in n


def test_bridge_spans_on_the_module_path():
    """A ``sat_state`` generator, which the fast path does not specialise,
    renders on the module path: one concat per MAT norm a pass."""
    gen = S2PGenerator(CFG["state_dim"], device="cpu", mat_mode="sat_state",
                       **{k: CFG[k] for k in GEN_KEYS}).requires_grad_(False)
    rows = bridge_rows(5)
    plain = generate_images_for_dataset(rows, gen, batch_size=2)
    with cpu_profile() as prof:
        traced = generate_images_for_dataset(rows, gen, batch_size=2)
    np.testing.assert_array_equal(plain, traced)
    n = counts(spans_of(prof))
    norms = sum(hasattr(getattr(gen, f"block_{i}"), k) for i in range(len(gen.sizes))
                for k in ("norm_0", "norm_1", "norm_s"))
    assert n["s2p.gen.forward"] == 3
    assert n["s2p.mat.cond"] == n["s2p.mat.norm"] == norms * 3
    assert not [k for k in n if k.startswith("s2p.fast.")]


def tiny_trainer():
    return GANTrainer.create(
        CFG["state_dim"], image_size=25, device="cpu", use_perceptual=False,
        generator_kwargs={k: CFG[k] for k in GEN_KEYS if k != "image_size"},
        discriminator_kwargs=dict(ndf=8, n_layers=2, num_scales=1),
        loss_cfg=GANLossConfig(r1_gamma=1.0, r1_interval=2))


def train_batch(batch=2, seed=0):
    rs = np.random.RandomState(seed)
    return dict(prev_image=rs.randint(0, 256, (batch, 25, 25, 3), dtype=np.uint8),
                state=rs.randn(batch, CFG["state_dim"]).astype(np.float32),
                target_image=rs.randint(0, 256, (batch, 25, 25, 3), dtype=np.uint8))


def test_trainer_records_r1_only_on_the_r1_step():
    tr = tiny_trainer()
    seen = []
    for step in range(3):  # R1 every 2nd D update: steps 0 and 2
        with cpu_profile() as prof:
            tr.train_step(train_batch(seed=step))
        seen.append(counts(spans_of(prof)))
    assert [n.get("s2p.train.r1", 0) for n in seen] == [1, 0, 1]
    for n in seen:
        assert n["s2p.train.stage"] == n["s2p.train.d_update"] == n["s2p.train.g_update"] == 1
        assert n["s2p.train.apply"] == 2  # D's and G's
        assert n["s2p.train.cast"] == 4  # G and D, in each update
        assert n["s2p.gen.forward"] == 2  # D's fake, G's update


# -- the benchmark's reduction ------------------------------------------------

def ev(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if args:
        e["args"] = args
    return e


WINDOW = ev("user_annotation", "portbench.window", 0.0, 100.0)
BASE = [
    WINDOW,
    ev("user_annotation", "portbench.call", 0.0, 80.0),
    ev("kernel", "k1", 10.0, 20.0, tid=20, correlation=1),
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 30.0, 8.0, tid=20, correlation=2),
    ev("kernel", "k3", 60.0, 10.0, tid=20, correlation=3),
    ev("kernel", "k4", 95.0, 10.0, tid=20, correlation=4),  # runs past the window's end
    ev("kernel", "before", -20.0, 5.0, tid=20, correlation=9),  # before the window
]
# busy 10–38, 60–70, 95–100; idle 0–10 (middle 5), 38–60 (49), 70–95 (82.5)
PROGRAM = [
    ev("user_annotation", "s2p.gen.forward", 2.0, 80.0),
    ev("user_annotation", "s2p.mat.hidden", 4.0, 30.0),
    ev("user_annotation", "s2p.fast.cmap", 5.0, 10.0),
    ev("user_annotation", "s2p.mat.norm", 45.0, 25.0),
    ev("user_annotation", "s2p.gen.forward", 120.0, 5.0),  # after the window
    ev("user_annotation", "s2p.train.apply", 82.2, 15.8),
    ev("cuda_runtime", "cudaLaunchKernel", 6.0, 1.0, correlation=1),
    ev("cuda_runtime", "cudaMemcpyAsync", 20.0, 1.0, correlation=2),
    ev("cuda_runtime", "cudaStreamSynchronize", 22.0, 8.0),
    ev("cuda_driver", "cuLaunchKernel", 52.0, 1.0, correlation=3),
    ev("cuda_runtime", "cudaLaunchKernel", 85.0, 1.0, tid=3, correlation=4),  # autograd's thread
    ev("cuda_runtime", "cudaDeviceSynchronize", 90.0, 5.0),
    ev("cuda_runtime", "cudaLaunchKernel", 82.1, 0.05, correlation=5),  # in no span; no op
    ev("cuda_runtime", "cudaStreamSynchronize", -10.0, 1.0),  # before the window
]


def test_spans_summarize_counts_launches_time_syncs_and_idle():
    s = spans.summarize({"traceEvents": BASE + PROGRAM}, "portbench.window")
    assert s["syncs"] == 2
    expect = {  # count, launches, device_s, syncs, idle_s
        "s2p.gen.forward": (1, 2, 38e-6, 1, 32e-6),  # k1, the copy, k3; gaps at 5 and 49
        "s2p.mat.hidden": (1, 1, 28e-6, 1, 10e-6),
        "s2p.fast.cmap": (1, 1, 20e-6, 0, 10e-6),
        "s2p.mat.norm": (1, 1, 10e-6, 0, 22e-6),
        "s2p.train.apply": (1, 1, 5e-6, 1, 25e-6),  # k4 cut at the window's end
    }
    assert set(s["by_name"]) == set(expect)
    for name, (count, launches, device_s, syncs, idle_s) in expect.items():
        row = s["by_name"][name]
        assert (row["count"], row["launches"], row["syncs"]) == (count, launches, syncs), name
        assert row["device_s"] == pytest.approx(device_s), name
        assert row["idle_s"] == pytest.approx(idle_s), name


def test_self_ops_go_to_the_innermost_span():
    rows = spans.self_ops({"traceEvents": BASE + PROGRAM}, "portbench.window")
    assert [r[:3] for r in rows] == [["s2p.fast.cmap", "k1", 1], ["s2p.mat.norm", "k3", 1],
                                     ["s2p.mat.hidden", "Memcpy HtoD (Pageable -> Device)", 1],
                                     ["s2p.train.apply", "k4", 1]]
    assert [r[3] for r in rows] == pytest.approx([20e-6, 10e-6, 8e-6, 5e-6])
    calls_only = [e for e in PROGRAM if e["cat"] != "user_annotation"]
    rows = spans.self_ops({"traceEvents": BASE + calls_only}, "portbench.window")
    assert {r[0] for r in rows} == {"portbench.window"} and len(rows) == 4


def test_trace_summary_is_the_same_with_program_spans():
    plain = trace.summarize({"traceEvents": BASE}, "portbench.window")
    spanned = trace.summarize({"traceEvents": BASE + PROGRAM}, "portbench.window")
    for key in ("window_s", "busy_s", "htod_s", "kernels", "ops", "device_ops"):
        assert spanned[key] == plain[key], key
    assert dict(plain["idle_gaps"]) == pytest.approx({"portbench.call": 32e-6,
                                                      "portbench.window": 25e-6})
    # each gap goes to the innermost span open at its middle: now the program's
    assert dict(spanned["idle_gaps"]) == pytest.approx({"s2p.fast.cmap": 10e-6,
                                                        "s2p.mat.norm": 22e-6,
                                                        "s2p.train.apply": 25e-6})


def read(name, rec):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(rec)


def test_span_readers():
    doc = {"traceEvents": BASE + PROGRAM}
    summary = dict(trace.summarize(doc, "portbench.window"),
                   spans=spans.summarize(doc, "portbench.window"))
    rec = dict(trace=summary, window_s=summary["window_s"], units={"frames": 4})
    busy = summary["busy_s"]
    assert busy == pytest.approx(43e-6)
    assert read("syncs_per_pass.gen", rec) == read("syncs_per_pass.bridge", rec) == 2.0
    assert read("cmap_share.gen", rec) == pytest.approx(100 * 20e-6 / busy)
    assert read("cond_cat_share.bridge", rec) is None  # no s2p.mat.cond span in this trace
    silent = [dict(rec, trace=plain) for plain in (
        trace.summarize({"traceEvents": BASE}, "portbench.window"),  # the parent: no spans
        dict(summary, spans=spans.summarize({"traceEvents": BASE + PROGRAM[1:]},
                                            "portbench.window")))]  # no pass recorded
    silent.append(dict(rec, trace=None))  # an untraced run
    for r in silent:
        for name in ("syncs_per_pass.gen", "syncs_per_pass.bridge", "cmap_share.gen",
                     "cond_cat_share.bridge"):
            assert read(name, r) is None, name


def test_span_metrics_are_stated_as_the_manifest_states_metrics():
    """The entries a ``BENCHMARK.json`` would take: the contract's keys, a
    reader each, moving an end-to-end metric of the cells they name."""
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    ends = {m["name"]: m.get("workloads") for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in spans.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert set(m["workloads"]) <= cells and set(m["workloads"]) <= set(ends[m["moves"]])
        assert hasattr(harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py"),
                       "read")
