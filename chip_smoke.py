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
5. serving throughput (a main path): the same generator in bf16 runs
   ``generate_rollout_fast`` at batch 256 × seq_len 8; prints frames/sec and
   checks the frames are finite. Every launch count is reset to 0 just
   before this phase and read just after it (no backward launch).
6. backward kernel vs plain: ``fused_mat_norm_bwd`` against
   ``fused_mat_norm_bwd_plain`` at every norm shape of the 100px/ngf=64
   training step (batch 16, bf16 and f32, γ separate and as a strided
   half of one γ‖β tensor) and ragged channel counts; the whole
   ``FusedMATNorm`` against autograd of ``fused_mat_norm_plain``. Times
   kernel, plain version and the autograd backward of ``F.instance_norm``
   (a partial yardstick) per shape beside the bound; the forward kernel is
   timed at the same shapes.
7. training parity: one ``GANTrainer.train_step`` of the full-width
   training configuration (100px, ngf=64, ndf=64, 2 scales × 4 layers, VGG
   loss, R1 on at step 0, state dim 17) at batch 2 in f32 with TF32 off,
   on the card and on the CPU (plain forward and backward; in f32 and, as
   the reference, in f64) from the same seeded weights and uint8 batch:
   the card's metrics and G and D gradients must be as close to the f64
   step's as the CPU's f32 ones are (within 3×), every G parameter must
   get a non-zero gradient, and the step
   must launch the forward kernel 26 times and the backward 13 times. D's
   learning rate is 0 in this step: Adam's first step is ≈ lr·sign(g), so
   float noise in a D gradient near zero would move that weight by ±lr
   and the G gradients, taken against the updated D, would inherit it.
8. training throughput (a main path): the protocol configuration at batch
   16 in bf16 and in f32 (TF32 convs, PyTorch's default): 32 timed
   ``train_step``s (R1 fires at D steps 0 and 16) and one ``train_many``
   chunk; prints steps/sec and images/sec and checks the losses are
   finite. The launch counts are reset to 0 just before the bf16 window
   and read just after it.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``. ``--profile DIR`` also writes a
torch.profiler summary of one throughput rollout and of one bf16 train
step to DIR.
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
# the training protocol: docs/E2E_RESULTS.md, s2p_tpu/cli/train_gan.py defaults
TRAIN_SIZE, TRAIN_BATCH, TIMED_STEPS, MANY_STEPS = 100, 16, 32, 16
TRAIN_D = dict(ndf=64, num_scales=2, n_layers=4)
# backward kernel vs plain, relative to max|plain|: f32 sums over up to
# 10,000 pixels in another order (~1e-6 seen); bf16 outputs may differ by
# one bf16 rounding step (2^-8) of the largest element
BWD_F32_TOL, BWD_BF16_TOL = 1e-4, 1e-2
# train step parity: the card's f32 step may be at most PARITY_SLACK times
# as far from the f64 CPU step as the CPU's f32 step is (f32 sums in R1's
# double backward and in the backward through the instance norms of D's
# small coarse-scale maps cancel, so the f32 error is set by the
# configuration, which the CPU's f32 run measures); floors: relative for
# metrics, of the module's largest |gradient| for gradients
PARITY_SLACK, METRIC_FLOOR, GRAD_FLOOR = 3.0, 1e-5, 1e-4


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

    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(TIMED_ROLLOUTS):
        frames = generate_rollout_fast(gen, init, states)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ck.fused_mat_norm.launches
    if ck.fused_mat_norm_bwd.launches:
        fail("the inference path launched the backward kernel")

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
        profile_device(lambda: generate_rollout_fast(gen, init, states), profile_dir,
                       "rollout")
    return launches


# kinds of device work, by kernel name (first match wins)
KERNEL_KINDS = (
    ("MAT-norm backward kernel", ("fused_mat_norm_bwd",)),
    ("MAT-norm forward kernel", ("fused_mat_norm",)),
    ("cuDNN/cuBLAS convs and GEMMs", ("xmma", "cutlass", "cudnn", "nhwcAddPadding", "gemm",
                                      "nchwToNhwc", "nhwcToNchw")),
    ("reductions", ("reduce_kernel",)),
    ("copies, casts, cat, memsets", ("copy", "memcpy", "memset", "CatArray")),
    ("Adam (foreach)", ("multi_tensor_apply",)),
    ("pooling and upsampling", ("upsample", "pool")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other elementwise"


def profile_device(fn, out_dir: str, name: str) -> None:
    """Device time by kernel and by kind over one call of ``fn``, and the
    device's idle share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():  # device-side events only: kernels, copies, sets
        if str(evt.device_type).endswith("CUDA") and not getattr(evt, "is_user_annotation",
                                                                  False):
            us = getattr(evt, "device_time_total", None)
            if us is None:
                us = evt.cuda_time_total
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    kinds: dict = {}
    for n, ms, c in rows:
        k = kinds.setdefault(kernel_kind(n), [0.0, 0])
        k[0] += ms
        k[1] += c
    kinds = dict(sorted(kinds.items(), key=lambda kv: -kv[1][0]))
    summary = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                   device_idle_share=1 - busy_ms / wall_ms, launches=sum(r[2] for r in rows),
                   kinds={k: dict(ms=ms, count=c) for k, (ms, c) in kinds.items()},
                   kernels=[dict(name=n[:120], ms=ms, count=c) for n, ms, c in rows[:40]])
    with open(os.path.join(out_dir, f"profile_{name}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    prof.export_chrome_trace(os.path.join(out_dir, f"profile_{name}_trace.json"))
    print(f"profile: one {name} {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
          f"(idle share {summary['device_idle_share']:.3f}), {summary['launches']} launches")
    for k, (ms, c) in kinds.items():
        print(f"  {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  {c:5d}x  {k}")
    for n, ms, c in rows[:12]:
        print(f"  {ms:9.3f} ms  {c:5d}x  {n[:90]}")


def phase_backward(ck, shapes) -> dict:
    import torch
    import torch.nn.functional as F

    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def rel_check(got, ref, dtype, label):
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        max_err[dtype] = max(max_err[dtype], err)
        tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
        if not torch.isfinite(got).all() or err > tol * scale:
            fail(f"{label}: max |err| {err:.3g} against max |ref| {scale:.3g}")

    def inputs(batch, size, C, dtype, strided, seed):
        x, g, b = mat_norm_inputs(batch, size, C, dtype, strided, mean=0.5, seed=seed)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        dy = torch.randn(x.shape, device="cuda", generator=gen).to(dtype)
        _, mean, rstd = ck._plain_forward(x, g, b, 1e-5)
        return x, g, b, dy, mean.float().contiguous(), rstd.float().contiguous()

    def check(batch, size, C, dtype, strided):
        label = f"B={batch} H=W={size} C={C} {dtype} strided={strided}"
        x, g, b, dy, mean, rstd = inputs(batch, size, C, dtype, strided, seed=size * C + 7)
        dx, dg = ck.fused_mat_norm_bwd(dy, x, g, mean, rstd)
        rdx, rdg = ck.fused_mat_norm_bwd_plain(dy, x, g, mean, rstd)
        rel_check(dx, rdx, dtype, f"fused_mat_norm_bwd dx at {label}")
        rel_check(dg, rdg, dtype, f"fused_mat_norm_bwd dgamma at {label}")
        # the whole Function against autograd of the plain forward
        leaves = [t.detach().requires_grad_() for t in (x, g, b)]
        got = torch.autograd.grad(ck.fused_mat_norm(*leaves), leaves, dy)
        ref = torch.autograd.grad(ck.fused_mat_norm_plain(*leaves), leaves, dy)
        for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
            rel_check(a, r, dtype, f"FusedMATNorm {name} vs autograd(plain) at {label}")

    before = ck.fused_mat_norm_bwd.launches
    step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, instance_norm_bwd_ms=0.0,
                fwd_ms=0.0, fwd_plain_ms=0.0, fwd_bound_ms=0.0)
    step_f32 = dict(ms=0.0, bound_ms=0.0, fwd_ms=0.0, fwd_bound_ms=0.0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for (size, C), per_step in sorted(shapes.items()):
            for strided in (False, True):
                check(TRAIN_BATCH, size, C, dtype, strided)
            # the module path's layout: γ and β separate conv outputs
            x, g, b, dy, mean, rstd = inputs(TRAIN_BATCH, size, C, dtype, False, seed=size + C)
            ms = time_ms(lambda: ck.fused_mat_norm_bwd(dy, x, g, mean, rstd))
            plain_ms = time_ms(lambda: ck.fused_mat_norm_bwd_plain(dy, x, g, mean, rstd))
            fwd_ms = time_ms(lambda: ck._launch_forward(x, g, b, 1e-5, True))
            fwd_plain_ms = time_ms(lambda: ck._plain_forward(x, g, b, 1e-5))
            xr = x.permute(0, 3, 1, 2).detach().requires_grad_()
            y = F.instance_norm(xr, eps=1e-5)
            dyr = dy.permute(0, 3, 1, 2)
            inorm_ms = time_ms(lambda: torch.autograd.grad(y, xr, dyr, retain_graph=True))
            nbytes = x.numel() * x.element_size()
            bound_ms = 5 * nbytes / HBM_BYTES_PER_S * 1e3
            fwd_bound_ms = 4 * nbytes / HBM_BYTES_PER_S * 1e3
            print(f"mat_norm_bwd {name} B={TRAIN_BATCH} H=W={size} C={C} x{per_step}/step: "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"F.instance_norm backward {inorm_ms:.4f} ms  bound {bound_ms:.4f} ms  "
                  f"| forward kernel {fwd_ms:.4f} ms  plain {fwd_plain_ms:.4f} ms  "
                  f"bound {fwd_bound_ms:.4f} ms")
            acc = step if dtype == torch.bfloat16 else step_f32
            for k, v in dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             instance_norm_bwd_ms=inorm_ms, fwd_ms=fwd_ms,
                             fwd_plain_ms=fwd_plain_ms, fwd_bound_ms=fwd_bound_ms).items():
                if k in acc:
                    acc[k] += per_step * v
    for dtype in (torch.bfloat16, torch.float32):  # channel counts off the 32 grid
        for size, C in ((13, 12), (8, 100), (5, 40)):
            for strided in (False, True):
                check(3, size, C, dtype, strided)
    if ck.fused_mat_norm_bwd.launches <= before:
        fail("fused_mat_norm_bwd's launch counter did not move")
    print(f"mat_norm_bwd max |kernel - plain|: f32 {max_err[torch.float32]:.3g}, bf16 "
          f"{max_err[torch.bfloat16]:.3g} (tolerance: f32 {BWD_F32_TOL}, bf16 "
          f"{BWD_BF16_TOL}, of max |plain|)")
    print("mat_norm per 100px/ngf=64 train step at batch 16 (13 norms each way): bf16 "
          + ", ".join(f"{k} {v:.4f}" for k, v in step.items()) + "; f32 "
          + ", ".join(f"{k} {v:.4f}" for k, v in step_f32.items()))
    return dict(step, f32=step_f32, max_abs_err=max_err[torch.float32],
                max_abs_err_bf16=max_err[torch.bfloat16])


def make_trainer(device, compute_dtype, d_lr=4e-4):
    import torch

    from s2p_tpu_torch.gan.losses import GANLossConfig
    from s2p_tpu_torch.gan.training import GANOptConfig, GANTrainer

    return GANTrainer.create(
        STATE_DIM, image_size=TRAIN_SIZE, generator_kwargs=dict(ngf=64),
        discriminator_kwargs=TRAIN_D, loss_cfg=GANLossConfig(r1_gamma=1.0, r1_interval=16),
        opt_cfg=GANOptConfig(d_lr=d_lr), compute_dtype=compute_dtype, seed=0,
        device=torch.device(device))


def synthetic_pairs(n: int, seed: int):
    """A seeded stand-in for the cheetah pair dataset: n uint8 100px frames
    and states, episodes of 64 steps."""
    import numpy as np

    from s2p_tpu_torch.data.pair_dataset import S2PPairDataset

    rs = np.random.RandomState(seed)
    timeouts = np.zeros(n, np.float32)
    timeouts[63::64] = 1.0
    return S2PPairDataset.from_dataset(dict(
        image_observations=rs.randint(0, 256, (n, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8),
        next_observations=rs.randn(n, STATE_DIM).astype(np.float32), timeouts=timeouts))


def check_avg_pool_backward() -> None:
    """D's 3×3/2 average pool (count_include_pad=False) differentiated on the
    card against float64 on the CPU: the port's ``avg_pool_2x``, and
    PyTorch's pool on a channels_last input, which it avoids."""
    import torch
    import torch.nn.functional as F

    from s2p_tpu_torch.gan.discriminator import avg_pool_2x

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 2 * 3 + STATE_DIM, TRAIN_SIZE, TRAIN_SIZE, generator=gen,
                    dtype=torch.float64)
    dy = torch.randn(2, x.shape[1], TRAIN_SIZE // 2, TRAIN_SIZE // 2, generator=gen,
                     dtype=torch.float64)

    def grad(fn, xin, dyin):
        xin = xin.detach().requires_grad_()
        return torch.autograd.grad(fn(xin), xin, dyin)[0].double().cpu()

    pool = lambda t: F.avg_pool2d(t, 3, stride=2, padding=1, count_include_pad=False)
    ref = grad(pool, x, dy)
    x_cl = x.float().cuda().contiguous(memory_format=torch.channels_last)
    errs = [((grad(fn, x_cl, dy.float().cuda()) - ref).norm() / ref.norm()).item()
            for fn in (avg_pool_2x, pool)]
    print(f"avg_pool_2x backward on the card against f64: relative error {errs[0]:.3g}; "
          f"PyTorch's pool on the channels_last input: {errs[1]:.3g}")
    if errs[0] > 1e-5:
        fail(f"avg_pool_2x backward on the card: relative error {errs[0]:.3g}")


def phase_train_parity(ck) -> None:
    import numpy as np
    import torch

    check_avg_pool_backward()
    batch = synthetic_pairs(8, seed=11).eval_batch(0, 2)
    runs = {}
    for name, device, dtype in (("cpu f64", "cpu", torch.float64), ("cpu f32", "cpu", torch.float32),
                                ("cuda f32", "cuda", torch.float32)):
        trainer = make_trainer(device, dtype, d_lr=0.0)
        before = (ck.fused_mat_norm.launches, ck.fused_mat_norm_bwd.launches)
        t0 = time.time()
        metrics = {k: v.item() for k, v in trainer.train_step(batch).items()}
        seconds = time.time() - t0
        launches = (ck.fused_mat_norm.launches - before[0],
                    ck.fused_mat_norm_bwd.launches - before[1])
        grads = {mod: {k: p.grad.double().cpu() for k, p in getattr(trainer, mod).named_parameters()}
                 for mod in ("generator", "discriminator")}
        runs[name] = (metrics, grads)
        print(f"train parity {name}: one step {seconds:.1f} s, " + ", ".join(
            f"{k} {v:.8g}" for k, v in sorted(metrics.items())))
        del trainer
    (ref_m, ref_g), (cpu_m, cpu_g), (got_m, got_g) = runs.values()
    if sorted(got_m) != sorted(ref_m) or not ref_m["d_r1"] > 0:
        fail(f"train step metrics {sorted(got_m)} (d_r1 {ref_m.get('d_r1')})")
    # the card's f32 step must be as close to the f64 step as the CPU's f32
    # step is: within PARITY_SLACK times the CPU's error, or the floor
    for k, r in ref_m.items():
        e_cpu, e_got = (abs(m[k] - r) / abs(r) for m in (cpu_m, got_m))
        if not np.isfinite(got_m[k]) or e_got > max(PARITY_SLACK * e_cpu, METRIC_FLOOR):
            fail(f"train step metric {k}: cuda {got_m[k]}, cpu {cpu_m[k]}, f64 {r}")
    for mod, ref in ref_g.items():
        scale = max(g.abs().max().item() for g in ref.values())

        def worst(grads):
            return max(((grads[k] - r).abs().max().item() / scale, k) for k, r in ref.items())

        (e_cpu, k_cpu), (e_got, k_got) = worst(cpu_g[mod]), worst(got_g[mod])
        print(f"train parity {mod} gradients against f64, of the largest |gradient| "
              f"{scale:.3g}: cuda {e_got:.3g} ({k_got}), cpu {e_cpu:.3g} ({k_cpu})")
        if e_got > max(PARITY_SLACK * e_cpu, GRAD_FLOOR):
            fail(f"{mod} gradients of the card's train step: {e_got:.3g} from f64 "
                 f"(the CPU's f32 step: {e_cpu:.3g})")
    zero = [k for k, g in got_g["generator"].items() if not g.abs().max().item() > 0]
    if zero:
        fail(f"G parameters with a zero gradient on the card: {zero}")
    print(f"train parity: the card's step launched fused_mat_norm {launches[0]}x and "
          f"fused_mat_norm_bwd {launches[1]}x (expected 26 and 13); every G parameter has a "
          f"non-zero gradient")
    if launches != (26, 13):
        fail(f"train step launched {launches} forward/backward MAT-norm kernels, expected (26, 13)")


def phase_train_throughput(ck, card: str, profile_dir: str | None) -> dict:
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, for the f32 run
    ds = synthetic_pairs(512, seed=12)
    batches = list(ds.batches(TRAIN_BATCH, np.random.RandomState(0)))
    data = dict(prev_image=torch.as_tensor(ds.prev_images, device="cuda"),
                state=torch.as_tensor(ds.states, device="cuda"),
                target_image=torch.as_tensor(ds.target_images, device="cuda"))
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        trainer = make_trainer("cuda", dtype)
        for b in batches[:2]:  # warm-up
            trainer.train_step(b)
        torch.cuda.synchronize()
        trainer.g_step = trainer.d_step = 0  # so R1 fires at D steps 0 and 16 in the window
        if dtype == torch.bfloat16:
            ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
        t0 = time.perf_counter()
        metrics = [trainer.train_step(batches[i % len(batches)]) for i in range(TIMED_STEPS)]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        if dtype == torch.bfloat16:
            launches = dict(fwd=ck.fused_mat_norm.launches, bwd=ck.fused_mat_norm_bwd.launches)
        sps = TIMED_STEPS / elapsed
        print(f"train throughput {name}: {sps:.3f} steps/sec, {sps * TRAIN_BATCH:.1f} "
              f"images/sec ({elapsed / TIMED_STEPS * 1e3:.2f} ms per train_step, "
              f"{TIMED_STEPS} steps, batch {TRAIN_BATCH}, 100px, ngf=64, ndf=64, VGG on, R1 "
              f"every 16 D steps) on {card}")
        values = torch.stack([v for m in metrics for v in m.values()])
        if not torch.isfinite(values).all():
            fail(f"train_step {name}: non-finite losses")
        gen = torch.Generator(device="cuda").manual_seed(3)
        t0 = time.perf_counter()
        many = trainer.train_many(data, MANY_STEPS, TRAIN_BATCH, gen)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        print(f"train throughput {name} train_many: {MANY_STEPS / elapsed:.3f} steps/sec, "
              f"{MANY_STEPS * TRAIN_BATCH / elapsed:.1f} images/sec ({MANY_STEPS} steps, "
              f"dataset staged on the card) on {card}")
        if not all(torch.isfinite(v) for v in many.values()):
            fail(f"train_many {name}: non-finite losses")
        if profile_dir and dtype == torch.bfloat16:
            trainer.d_step = 1  # a step without R1, the common case
            profile_device(lambda: trainer.train_step(batches[0]), profile_dir, "train_step")
        del trainer
    expected = dict(fwd=26 * TIMED_STEPS, bwd=13 * TIMED_STEPS)
    print(f"train main path launches (bf16 window): {launches} (expected {expected})")
    if launches != expected:
        fail(f"training launched the MAT-norm kernels {launches}, expected {expected}")
    return launches


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

    # phase 5: serving throughput, a main path
    serving = phase_throughput(ck, gen_gpu.to(torch.bfloat16), card, args.profile)
    del gen_gpu

    # phase 6: backward kernel vs plain at the 100px training shapes
    gen100 = S2PGenerator(STATE_DIM, image_size=TRAIN_SIZE, ngf=64, device="cpu")
    bwd = phase_backward(ck, norm_shapes(gen100))

    # phase 7: one full-width train step, card vs CPU
    torch.backends.cudnn.allow_tf32 = False
    phase_train_parity(ck)

    # phase 8: training throughput, a main path
    training = phase_train_throughput(ck, card, args.profile)

    fwd_record = dict(
        name="fused_mat_norm", route="cuda", source="s2p_tpu_torch/csrc/fused_mat_norm.cu",
        replaces="s2p_tpu/gan/pallas_kernels.py:49", launches=serving + training["fwd"],
        launches_by_path=dict(serving=serving, training=training["fwd"]),
        max_abs_err=stats["max_abs_err"], max_abs_err_bf16=stats["max_abs_err_bf16"],
        ms=stats["ms"], plain_ms=stats["plain_ms"], bound_ms=stats["bound_ms"],
        bound_by="bytes", library_ms=None, instance_norm_ms=stats["instance_norm_ms"],
        train_step_ms=bwd["fwd_ms"], train_step_plain_ms=bwd["fwd_plain_ms"],
        train_step_bound_ms=bwd["fwd_bound_ms"],
        per="ms/plain_ms/bound_ms: one 64px/ngf=64 generator step at batch 256 in bf16 "
            "(13 norms); train_step_*: the 13 norms of a 100px/ngf=64 train step at batch "
            "16 in bf16; instance_norm_ms is F.instance_norm alone, a partial yardstick",
    )
    bwd_record = dict(
        name="fused_mat_norm_bwd", route="cuda", source="s2p_tpu_torch/csrc/fused_mat_norm.cu",
        replaces="s2p_tpu/gan/pallas_kernels.py:49", launches=training["bwd"],
        launches_by_path=dict(serving=0, training=training["bwd"]),
        max_abs_err=bwd["max_abs_err"], max_abs_err_bf16=bwd["max_abs_err_bf16"],
        ms=bwd["ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["bound_ms"], bound_by="bytes",
        library_ms=None, instance_norm_bwd_ms=bwd["instance_norm_bwd_ms"],
        per="the gradient of fused_mat_norm (the JAX package has no backward kernel: XLA "
            "differentiates the plain norm); one 100px/ngf=64 train step at batch 16 in "
            "bf16 (13 norms); instance_norm_bwd_ms is the autograd backward of "
            "F.instance_norm alone, a partial yardstick",
    )
    print(json.dumps({"kernels": [fwd_record, bwd_record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
