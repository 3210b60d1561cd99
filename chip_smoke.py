#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (s2p_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which must pass (the script stops at the first failure):

1. device: CUDA must be available; prints the card's name and power limit.
2. build: compiles every CUDA kernel of the port from ``s2p_tpu_torch/csrc``.
3. kernels vs plain: each kernel's wrapper against its plain PyTorch
   version on the card, at every shape the 64px/ngf=64 main path gives it
   (batch 256, bf16 and f32, γ/β as strided halves of one γ‖β tensor as the
   fast path passes them, and contiguous as the module path does), the
   100px chain's odd shapes, channel counts that are not multiples of 8 or
   32, and a |mean| ≫ std input. Times kernel, plain version and the
   ``F.instance_norm`` yardstick per shape beside the bound.
4. slice parity: a full-width cheetah generator (64px, ngf=64, state dim
   17, seeded random weights) runs ``generate_rollout_fast`` and
   ``generate_rollout`` (seq_len 5, batch 4, f32, TF32 off) on the card and
   on the CPU (plain norm); the frames must agree to 5e-3, and the kernel
   must have launched 13 times per step.
5. throughput (the main path): the same generator in bf16 runs
   ``generate_rollout_fast`` at batch 256 × seq_len 8; prints frames/sec and
   checks the frames are finite. Every launch count is reset to 0 just
   before this phase and read just after it.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``. ``--profile DIR`` also writes a
torch.profiler summary of one throughput rollout to DIR.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
STATE_DIM = 17  # cheetah
FULL = dict(image_size=64, ngf=64, state_freqs=6, state_embed_dim=256, mat_hidden=128)
BF16_TOL = 1e-2  # rtol and atol: one bf16 rounding step (2^-7 relative) of the same f32 value
F32_TOL = 1e-5
ROLLOUT_TOL = 5e-3  # tests/test_fast_inference.py:137
BATCH, SEQ_LEN, TIMED_ROLLOUTS = 256, 8, 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def norm_shapes(gen) -> dict:
    """(H, C) → launches per generator step, from the generator's blocks:
    norm_0 on the block input, norm_1 on min(in, out), norm_s on the input
    when the channel count changes."""
    shapes: dict = {}
    for size, (c_in, c_out) in zip(gen.sizes, gen.block_channels):
        for c in [c_in, min(c_in, c_out)] + ([c_in] if c_in != c_out else []):
            shapes[(size, c)] = shapes.get((size, c), 0) + 1
    return shapes


def mat_norm_inputs(batch, size, C, dtype, strided, mean=0.0, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (mean + torch.randn(batch, size, size, C, device="cuda", generator=g)).to(dtype)
    gb = (0.5 * torch.randn(batch, size, size, 2 * C, device="cuda", generator=g)).to(dtype)
    if not strided:
        gb = gb.view(batch, size, size, 2, C).movedim(3, 0).contiguous()
        return x, gb[0], gb[1]
    return x, gb[..., :C], gb[..., C:]


def phase_kernels(ck, shapes) -> dict:
    import torch
    import torch.nn.functional as F

    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def check(x, g, b, label):
        out = ck.fused_mat_norm(x, g, b)
        ref = ck.fused_mat_norm_plain(x, g, b)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        atol, rtol = (F32_TOL, 0.0) if x.dtype == torch.float32 else (BF16_TOL, BF16_TOL)
        bad = err > atol + rtol * ref.float().abs()
        max_err[x.dtype] = max(max_err[x.dtype], err.max().item())
        if not torch.isfinite(out).all() or bad.any():
            fail(f"fused_mat_norm vs plain at {label}: max |err| {err.max().item():.3g}")

    launches_before = ck.fused_mat_norm.launches
    step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, instance_norm_ms=0.0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for (size, C), per_step in sorted(shapes.items()):
            for strided in (True, False):
                x, g, b = mat_norm_inputs(BATCH, size, C, dtype, strided, seed=size * C)
                check(x, g, b, f"B={BATCH} H=W={size} C={C} {name} strided={strided}")
            x, g, b = mat_norm_inputs(BATCH, size, C, dtype, strided=True, seed=size * C)
            ms = time_ms(lambda: ck.fused_mat_norm(x, g, b))
            plain_ms = time_ms(lambda: ck.fused_mat_norm_plain(x, g, b))
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, as the generator holds it
            inorm_ms = time_ms(lambda: F.instance_norm(x_nchw, eps=1e-5))
            bound_ms = 4 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            print(f"mat_norm {name} B={BATCH} H=W={size} C={C} x{per_step}/step: "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"F.instance_norm {inorm_ms:.4f} ms  bound {bound_ms:.4f} ms")
            if dtype == torch.bfloat16:  # the main path's working type
                step["ms"] += per_step * ms
                step["plain_ms"] += per_step * plain_ms
                step["bound_ms"] += per_step * bound_ms
                step["instance_norm_ms"] += per_step * inorm_ms

    # 100px chain (odd H·W), channel counts off the 8/32 grid, |mean| >> std
    odd = [(7, 512), (13, 512), (13, 256), (25, 256), (25, 128), (50, 128), (50, 64),
           (100, 64), (13, 12), (8, 100), (5, 40)]
    for dtype in (torch.bfloat16, torch.float32):
        for size, C in odd:
            for strided in (True, False):
                x, g, b = mat_norm_inputs(16, size, C, dtype, strided, seed=size + C)
                check(x, g, b, f"B=16 H=W={size} C={C} {dtype} strided={strided}")
    for size in (4, 8):  # 256 + k/64 at a power-of-two H·W: exact two-pass statistics
        gen = torch.Generator(device="cuda").manual_seed(size)
        k = torch.randint(-64, 65, (16, size, size, 64), device="cuda", generator=gen)
        x = 256.0 + k.float() / 64.0
        _, g, b = mat_norm_inputs(16, size, 64, torch.float32, strided=True)
        check(x, g, b, f"|mean|>>std H=W={size}")

    if ck.fused_mat_norm.launches <= launches_before:
        fail("fused_mat_norm's launch counter did not move")
    print(f"mat_norm max |kernel - plain|: f32 {max_err[torch.float32]:.3g}, "
          f"bf16 {max_err[torch.bfloat16]:.3g} (tolerance f32 atol {F32_TOL}, "
          f"bf16 rtol=atol {BF16_TOL})")
    print("mat_norm per 64px/ngf=64 step at batch 256 bf16 (13 norms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in step.items()))
    return dict(step, max_abs_err=max_err[torch.float32],
                max_abs_err_bf16=max_err[torch.bfloat16])


def phase_parity(ck, gen_cpu, gen_gpu) -> None:
    import numpy as np
    import torch

    from s2p_tpu_torch.gan import generate_rollout, generate_rollout_fast

    rs = np.random.RandomState(0)
    img = torch.from_numpy((rs.rand(4, 64, 64, 3) * 2 - 1).astype(np.float32))
    states = torch.from_numpy(rs.randn(5, 4, STATE_DIM).astype(np.float32))
    per_step = sum(norm_shapes(gen_gpu).values())
    for name, fn in (("generate_rollout_fast", generate_rollout_fast),
                     ("generate_rollout", generate_rollout)):
        t0 = time.time()
        ref = fn(gen_cpu, img, states)
        cpu_s = time.time() - t0
        before = ck.fused_mat_norm.launches
        out = fn(gen_gpu, img.cuda(), states.cuda())
        torch.cuda.synchronize()
        launches = ck.fused_mat_norm.launches - before
        err = (out.cpu() - ref).abs().max().item()
        print(f"parity {name}: seq_len 5 batch 4 f32, max |cuda - cpu| {err:.3g} "
              f"(tolerance {ROLLOUT_TOL}), fused_mat_norm launches {launches} "
              f"({per_step}/step), cpu {cpu_s:.1f} s")
        if out.shape != (5, 4, 64, 64, 3) or not torch.isfinite(out).all():
            fail(f"{name}: bad output {tuple(out.shape)}")
        if err > ROLLOUT_TOL:
            fail(f"{name}: cuda and cpu rollouts differ by {err:.3g}")
        if launches != per_step * 5:
            fail(f"{name}: {launches} kernel launches, expected {per_step * 5}")


def phase_throughput(ck, gen, card: str, profile_dir: str | None) -> int:
    import torch

    from s2p_tpu_torch.gan import generate_rollout_fast

    g = torch.Generator(device="cuda").manual_seed(1)
    states = torch.randn(SEQ_LEN, BATCH, STATE_DIM, device="cuda", generator=g).bfloat16()
    init = (torch.rand(BATCH, 64, 64, 3, device="cuda", generator=g) * 2 - 1).bfloat16()
    for _ in range(2):
        generate_rollout_fast(gen, init, states)
    torch.cuda.synchronize()

    ck.fused_mat_norm.launches = 0
    t0 = time.perf_counter()
    for _ in range(TIMED_ROLLOUTS):
        frames = generate_rollout_fast(gen, init, states)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ck.fused_mat_norm.launches

    fps = BATCH * SEQ_LEN * TIMED_ROLLOUTS / elapsed
    print(f"throughput generate_rollout_fast 64px ngf=64 bf16 batch {BATCH} seq_len "
          f"{SEQ_LEN}: {fps:.1f} frames/sec ({elapsed / TIMED_ROLLOUTS * 1e3:.2f} ms per "
          f"rollout, {TIMED_ROLLOUTS} rollouts) on {card}")
    if frames.shape != (SEQ_LEN, BATCH, 64, 64, 3) or not torch.isfinite(frames).all():
        fail("throughput rollout produced a bad or non-finite output")
    expected = sum(norm_shapes(gen).values()) * SEQ_LEN * TIMED_ROLLOUTS
    if launches != expected:
        fail(f"main path launched fused_mat_norm {launches} times, expected {expected}")
    if profile_dir:
        profile_rollout(gen, init, states, profile_dir)
    return launches


def profile_rollout(gen, init, states, out_dir: str) -> None:
    """Device time by kernel over one throughput rollout, and the device's
    idle share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from s2p_tpu_torch.gan import generate_rollout_fast

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate_rollout_fast(gen, init, states)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():  # device-side events only: kernels, copies, sets
        if str(evt.device_type).endswith("CUDA"):
            us = getattr(evt, "device_time_total", None)
            if us is None:
                us = evt.cuda_time_total
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    summary = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                   device_idle_share=1 - busy_ms / wall_ms,
                   kernels=[dict(name=n[:120], ms=ms, count=c) for n, ms, c in rows[:40]])
    with open(os.path.join(out_dir, "profile_rollout.json"), "w") as f:
        json.dump(summary, f, indent=1)
    prof.export_chrome_trace(os.path.join(out_dir, "profile_rollout_trace.json"))
    print(f"profile: one rollout {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
          f"(idle share {summary['device_idle_share']:.3f})")
    for n, ms, c in rows[:12]:
        print(f"  {ms:9.3f} ms  {c:5d}x  {n[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also write a torch.profiler summary of one rollout to DIR")
    args = ap.parse_args()

    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from s2p_tpu_torch.gan import S2PGenerator
    from s2p_tpu_torch.gan import cuda_kernels as ck

    # phase 2: build
    t0 = time.time()
    ck.load_library()
    print(f"build: fused_mat_norm ({ck.SOURCE.name}) built and loaded in {time.time() - t0:.1f} s")

    # phase 3: kernels vs plain (the shapes come from the full-width generator)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen_cpu = S2PGenerator(STATE_DIM, seed=0, device="cpu", **FULL)
    stats = phase_kernels(ck, norm_shapes(gen_cpu))

    # phase 4: slice parity, card vs CPU
    gen_gpu = copy.deepcopy(gen_cpu).to("cuda")
    phase_parity(ck, gen_cpu, gen_gpu)

    # phase 5: throughput on the main path
    launches = phase_throughput(ck, gen_gpu.to(torch.bfloat16), card, args.profile)

    record = dict(
        name="fused_mat_norm", route="cuda", source="s2p_tpu_torch/csrc/fused_mat_norm.cu",
        replaces="s2p_tpu/gan/pallas_kernels.py:49", launches=launches,
        max_abs_err=stats["max_abs_err"], max_abs_err_bf16=stats["max_abs_err_bf16"],
        ms=stats["ms"], plain_ms=stats["plain_ms"], bound_ms=stats["bound_ms"],
        bound_by="bytes", library_ms=None, instance_norm_ms=stats["instance_norm_ms"],
        per="one 64px/ngf=64 generator step at batch 256 in bf16 (13 norms); "
            "instance_norm_ms is F.instance_norm alone, a partial yardstick",
    )
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
