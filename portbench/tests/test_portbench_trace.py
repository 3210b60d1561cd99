"""The trace reduction and the readers on a hand-made trace."""

import pytest

from portbench import harness, trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


DOC = {"traceEvents": [
    ev("user_annotation", "portbench.window", 0.0, 100.0),
    ev("user_annotation", "portbench.call", 0.0, 50.0),
    ev("user_annotation", "train.batch", 0.0, 10.0),
    ev("kernel", "void fused_mat_norm_kernel<float, 4, true>(FwdArgs<float>)", 10.0, 20.0),
    ev("kernel", "void fused_mat_norm_bwd_kernel<float, 4, true>(BwdArgs<float>)", 20.0, 20.0),
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60.0, 10.0),
    ev("kernel", "gemm", 90.0, 20.0),  # runs past the window's end
    ev("kernel", "before", -20.0, 5.0),  # before the window
]}


def test_summary_takes_the_union_and_attributes_gaps():
    s = trace.summarize(DOC, "portbench.window")
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 10 + 10) * 1e-6)  # 10–40, 60–70, 90–100
    assert s["htod_s"] == pytest.approx(10e-6)
    assert s["kernels"] == 3
    gaps = dict(s["idle_gaps"])
    assert gaps["train.batch"] == pytest.approx(10e-6)
    assert gaps["portbench.call"] == pytest.approx(20e-6)  # 40–60: its middle is in the call
    assert gaps["portbench.window"] == pytest.approx(20e-6)  # 70–90
    assert len(s["device_ops"]) == 4


def test_readers():
    s = trace.summarize(DOC, "portbench.window")
    cfg = {"state_dim": 3, "image_size": 4, "ngf": 1, "n_up": 1, "state_freqs": 1,
           "state_embed_dim": 2, "mat_hidden": 1, "out_channels": 3, "precision": "f32-tf32"}
    rec = dict(trace=s, window_s=s["window_s"], units={"steps": 1, "frames": 10},
               config=cfg, traffic={"batch": 2}, latencies_s=[],
               setup_s=1.0)
    read = lambda name: harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(rec)
    assert read("idle_share.train") == pytest.approx(50.0)
    assert read("launches_per_step.train") == 3
    assert read("h2d_share.bridge") == pytest.approx(10.0)
    # one forward kernel in the trace, not the 4 (2 passes x 2 norms) the shapes give
    assert read("mat_norm_roofline.train") is None
    assert read("rollout_p95_ms") is None  # no latencies to read
    assert read("setup_s") == 1.0
    for gen, bridge in (("gen_frames_per_s", "bridge_frames_per_s"),
                        ("idle_share.gen", "idle_share.bridge"),
                        ("launches_per_frame.gen", "launches_per_frame.bridge"),
                        ("mfu.gen", "mfu.bridge")):  # one quantity, a metric a cell
        assert read(bridge) == read(gen) is not None
