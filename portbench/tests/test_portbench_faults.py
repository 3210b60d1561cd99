"""A run of each cell, with the chip check skipped, at a tiny size on the CPU:
sound, it comes out correct; with the control in the program's place or
with the timed path broken underneath, it comes out not correct.

The limits are the cells' own (``workloads/<cell>.json``); the program runs
in float32 here, so that the sound run's readings sit far below them at any
size.
"""

import time

import pytest
import torch

from conftest import tiny_cell
from portbench import harness

CPU = torch.device("cpu")
GEN_CELLS = ["cheetah64-rollout-b256", "cheetah64-rollout-b1", "walker100-bridge-b256"]


def run(cell, seed=2**40 + 3):
    return harness.run_cell(cell, seed, 0.3, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", GEN_CELLS + ["walker100-train-b16"])
def test_sound_run_is_correct(name):
    res = run(tiny_cell(name, precision="f32-tf32"))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name", GEN_CELLS)
def test_control_fails(name):
    cell = tiny_cell(name, precision="f32-tf32")
    ctx = harness.Ctx(cell, 11, CPU)
    prog = cell.driver.setup(ctx)
    for i in range(cell.traffic.get("judged_calls", 1)):
        prog.call(i)
    readings = cell.driver.control(ctx, prog.finish(), "fp8")
    assert not harness.judge(readings, cell.limits), readings


def test_training_control_fails():
    cell = tiny_cell("walker100-train-b16", precision="f32-tf32")
    ctx = harness.Ctx(cell, 12, CPU)
    readings = cell.driver.control(ctx, cell.driver.setup(ctx).finish(), "fp8")
    assert not harness.judge(readings, cell.limits), readings


def _unchanged(gen_self, state, prev_image):  # a step that returns its state unchanged
    return prev_image.clone()


def _half_batch(fn):  # half of the batch left out: the second half repeats the first
    def broken(*args, **kw):
        out = fn(*args, **kw)
        half = out.shape[0] // 2 if out.dim() == 4 else None
        if half is None:
            half = out.shape[1] // 2
            out[:, half:2 * half] = out[:, :half]
        else:
            out[half:2 * half] = out[:half]
        return out
    return broken


def _altered(fn):  # one answer (a frame) altered where it is produced
    def broken(*args, **kw):
        out = fn(*args, **kw)
        out[0] = (out[0] + 0.5).clamp(-1, 1)
        return out
    return broken


@pytest.mark.parametrize("name", GEN_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_generation_fault_fails(name, fault, monkeypatch):
    import s2p_tpu_torch.cli.generate_images as bridge
    import s2p_tpu_torch.gan.fast_inference as fi
    import s2p_tpu_torch.gan.generator as g

    if fault == "unchanged":
        monkeypatch.setattr(g.S2PGenerator, "forward", _unchanged)
        broken = lambda gen, p, s, prev, *a: prev.clone()  # noqa: E731
    else:
        wrap = _half_batch if fault == "half_batch" else _altered
        monkeypatch.setattr(g.S2PGenerator, "forward", wrap(g.S2PGenerator.forward))
        broken = wrap(fi.fast_apply)
    # the bridge holds its own name for the fast path
    for module in (fi, bridge):
        monkeypatch.setattr(module, "fast_apply", broken)
    res = run(tiny_cell(name, precision="f32-tf32"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_training_fault_fails(fault, monkeypatch):
    from s2p_tpu_torch.gan import training

    step = training.GANTrainer.train_step
    if fault == "unchanged":  # the optimizers leave the parameters as they were
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(training.GANTrainer, "train_step", lambda self, b: step(
            self, {k: v[: len(v) // 2] for k, v in b.items()}))
    else:  # the step's answer, one trained leaf, altered where it is produced
        def altered(self, b):
            m = step(self, b)
            with torch.no_grad():
                next(self.generator.parameters()).mul_(1.5)
            return m
        monkeypatch.setattr(training.GANTrainer, "train_step", altered)
    res = run(tiny_cell("walker100-train-b16", precision="f32-tf32"))
    assert not res["correct"], res["checks"]
