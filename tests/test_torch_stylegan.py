"""StyleGAN (NVlabs/stylegan's ``G_style``) in the port against the benchmark's
plain reference (``portbench/reference/stylegan.py``), on the CPU at a tiny size.

The tiny generators keep every mechanism of FFHQ 1024²: 8 mapping layers of
512, truncation toward ``dlatent_avg`` on the first 4 synthesis layers,
noise and the blur; at 32² with ``fmap_max`` 64 every up-conv is a nearest
×2 and a 3×3 conv, at 128² with ``fmap_max`` 16 the 128² one is the fused
transposed conv (the official bound) and those below it nearest. Weights are
seeded in the official variables' names, biases, noise strengths and
``dlatent_avg`` away from 0. Float32 throughout; each tolerance says why it
is what it is. The MAT-norm kernel runs only on the card (``cuda``-marked
cases here, ``chip_smoke.py --stylegan`` there); here its plain version runs.
"""

import json
import math
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, spans
from portbench.counts import stylegan as style_counts
from portbench.reference import stylegan as ref
from portbench.reference.precision import Precision
from s2p_tpu_torch.gan import StyleGANGenerator, fuse_fast_params, synthesize_style_fast
from s2p_tpu_torch.gan import cuda_kernels as ck
from s2p_tpu_torch.gan import stylegan as sg

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "stylegan-ffhq-1024.json").read_text())
TINY = dict(CONFIG["G"], resolution=32, fmap_max=64, truncation_cutoff=4)
TINY_FUSED = dict(TINY, resolution=128, fmap_max=16)  # the up-conv into 128² fused
F32 = Precision("f32")
CPU = torch.device("cpu")
# f32 on both sides: the paths differ only in the order of float operations (ψ and
# dlatent_avg folded into one style GEMM, the nearest up-convs as transposed convs,
# the kernel's two-pass statistics), ~1e-7 relative an operation through 8 layers
# whose norms rescale by up to ~10; gaps are ÷ the frames' range
PATH_TOL = 2e-5


def seeded_weights(G, seed=0, noise=True) -> dict:
    """Weights in the official names: every weight N(0, 1/lrmul) as the
    official init draws it, biases N(0, 0.1²) at their run-time scale, noise
    strengths N(0, 0.2²) (0 with ``noise`` False), the constant N(0, 1),
    ``dlatent_avg`` N(0, 0.3²)."""
    g = torch.Generator().manual_seed(seed)
    lrmul = G["mapping_lrmul"]
    std = {"mapping_weight": 1 / lrmul, "weight": 1.0, "const": 1.0,
           "mapping_bias": 0.1 / lrmul, "bias": 0.1, "noise": 0.2 if noise else 0.0}
    W = {name: torch.randn(shape, generator=g) * std[kind]
         for name, (shape, kind) in ref.param_spec(G).items()}
    W["dlatent_avg"] = torch.randn(G["dlatent_size"], generator=g) * 0.3
    return W


def port_generator(G, W) -> StyleGANGenerator:
    gen = StyleGANGenerator(**G, device="cpu")
    gen.load_state_dict({k.replace("/", "."): v for k, v in W.items()}, strict=True)
    return gen.eval().requires_grad_(False)


def latents(n=3, seed=1):
    return torch.randn(n, 512, generator=torch.Generator().manual_seed(seed))


def gap(a, b) -> float:
    return ((a - b).abs().max() / (b.max() - b.min())).item()


# -- the generator --------------------------------------------------------------

@pytest.mark.parametrize("upsampling", ["nearest", "fused"])
@pytest.mark.parametrize("noise", [True, False], ids=["noise", "no_noise"])
@pytest.mark.parametrize("psi", [0.7, 1.0])
def test_module_and_fast_paths_match_the_reference(psi, noise, upsampling):
    """ψ 0.7 (truncated below the cutoff) or 1; noise strengths drawn or 0;
    every up-conv nearest + 3×3 conv (32²), or the fused transposed conv at
    128² (128²)."""
    G = dict(TINY_FUSED if upsampling == "fused" else TINY, truncation_psi=psi)
    W = seeded_weights(G, noise=noise)
    gen, z = port_generator(G, W), latents()
    noise_gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    want = ref.generator(W, G, z, ref.noise_maps(3, G, noise_gen(), CPU), F32, use_noise=noise)
    R = G["resolution"]
    assert want.shape == (3, R, R, 3) and want.std() > 0.1
    assert [r for r in (64, 128, 256) if gen.fused(r) and r <= R] == [128, 256][:R // 128]
    with torch.no_grad():
        module = gen(z, noise_gen())
    fast = synthesize_style_fast(gen, z, noise_gen())
    assert gap(module, want) < PATH_TOL and gap(fast, want) < PATH_TOL
    params = fuse_fast_params(gen)  # one fusion serves every call, with the same noise
    assert torch.equal(synthesize_style_fast(gen, z, noise_gen(), params),
                       synthesize_style_fast(gen, z, noise_gen(), params))
    if noise:  # the noise is there: another draw moves the frames
        assert gap(synthesize_style_fast(gen, z, torch.Generator().manual_seed(10), params),
                   want) > 100 * PATH_TOL


@pytest.mark.parametrize("path", ["fast", "module"])
def test_a_batch_of_one_leaves_the_constant_as_it_was(path):
    """The epilogue runs in place: at batch 1 the constant's broadcast is
    the constant itself, so each path copies it first."""
    gen = port_generator(TINY, seeded_weights(TINY))
    const = gen.G_synthesis.get_submodule("4x4.Const").const.clone()
    params = fuse_fast_params(gen)
    fused_const = params["blocks"][0][0]["const"].clone()
    noise = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    run = {"fast": lambda: synthesize_style_fast(gen, latents(1), noise(), params),
           "module": lambda: gen(latents(1), noise())}[path]
    first = run()
    assert torch.equal(run(), first)  # the same noise: the same frames again
    assert torch.equal(gen.G_synthesis.get_submodule("4x4.Const").const, const)
    assert torch.equal(params["blocks"][0][0]["const"], fused_const)


def test_the_same_seeded_generator_draws_bit_equal_noise():
    """The port's per-layer draws and the reference's list, from one seed:
    the same maps, bit for bit, in layer order."""
    g = torch.Generator().manual_seed(3)
    port = [sg.noise_map(4, i, g, CPU) for i in range(8)]
    want = ref.noise_maps(4, TINY, torch.Generator().manual_seed(3), CPU)
    assert [tuple(n.shape) for n in port] == [(4, 1, r, r) for r in (4, 4, 8, 8, 16, 16, 32, 32)]
    assert all(torch.equal(a, b) and a.dtype == torch.float32 for a, b in zip(port, want))


@pytest.mark.parametrize("c_in,c_out", [(5, 7), (32, 16)])
def test_fused_upsampling_is_nearest_and_a_flipped_conv(c_in, c_out):
    """``upscale2d_conv2d``'s fused transposed conv equals a nearest ×2 and a
    3×3 conv with the kernel flipped in both spatial axes (f32: the same sums
    in another order, ~1e-6 of the values); the port's kernel is the
    reference's."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, c_in, 6, 6, generator=g)
    w = torch.randn(c_out, c_in, 3, 3, generator=g)
    fused = F.conv_transpose2d(x, ref.fused_up_weight(w), stride=2, padding=1)
    nearest = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w.flip(2, 3), padding=1)
    assert fused.shape == nearest.shape == (2, c_out, 12, 12)
    assert (fused - nearest).abs().max() < 1e-5 * nearest.abs().max()
    assert torch.equal(sg.fused_up_kernel(w), ref.fused_up_weight(w))


def test_generator_widths_follow_stylegan():
    gen = StyleGANGenerator(**CONFIG["G"], device="meta")
    assert sum(p.numel() for p in gen.parameters()) == 26_212_019  # the paper's ~26.2 M
    assert style_counts.parameters(CONFIG["G"]) == 26_212_019
    assert gen.num_layers == 18
    assert [s[4] for s in gen.layer_specs][::2] == [512, 512, 512, 512, 256, 128, 64, 32, 16]
    assert [s[:3] for s in gen.layer_specs[:4]] == [
        ("4x4", "Const", "const"), ("4x4", "Conv", "conv"), ("8x8", "Conv0_up", "up"),
        ("8x8", "Conv1", "conv")]
    assert [r for r in (8, 16, 32, 64, 128, 256, 512, 1024) if gen.fused(r)] == [128, 256, 512,
                                                                                   1024]
    names = set(gen.state_dict())
    assert {"G_mapping.Dense7.weight", "G_synthesis.4x4.Const.const",
            "G_synthesis.1024x1024.Conv1.Noise.weight", "G_synthesis.8x8.Conv0_up.StyleMod.bias",
            "G_synthesis.ToRGB_lod0.weight", "dlatent_avg"} <= names
    assert {k.replace("/", ".") for k in ref.param_spec(CONFIG["G"])} | {"dlatent_avg"} == names
    assert gen.G_synthesis.ToRGB_lod0.weight.shape == (3, 16, 1, 1)
    assert all(gen.fused(r) == ref.fused(r) for r in (8, 64, 128, 1024))  # fused_scale='auto'
    with pytest.raises(ValueError, match="power of two"):
        StyleGANGenerator(**dict(CONFIG["G"], resolution=1000), device="meta")


def test_dlatent_avg_stays_float32_in_a_bf16_generator():
    G = TINY
    gen = port_generator(G, seeded_weights(G)).to(torch.bfloat16)
    assert gen.dlatent_avg.dtype == torch.float32
    assert gen.G_synthesis.get_submodule("4x4.Conv").weight.dtype == torch.bfloat16
    frames = synthesize_style_fast(gen, latents(), torch.Generator().manual_seed(2))
    assert frames.dtype == torch.bfloat16 and torch.isfinite(frames.float()).all()


def test_fast_operands_fold_the_style_affines_into_one_gemm():
    G = TINY
    gen = port_generator(G, seeded_weights(G))
    params = fuse_fast_params(gen)
    widths = [s[4] for s in gen.layer_specs]
    assert params["style"]["weight"].shape == (512, 2 * sum(widths))
    assert params["style"]["bias"].shape == (2 * sum(widths),)
    assert len(params["mapping"]) == 8 and len(params["blocks"]) == 4
    ups = [lp for pair in params["blocks"] for lp in pair if lp["kind"] == "up"]
    assert [tuple(lp["weight"].shape) for lp in ups] == [(64, 64, 4, 4)] * 3  # every up-conv
    with pytest.raises(ValueError, match="float only"):
        fuse_fast_params(gen, gb_int8=True)
    with pytest.raises(ValueError, match="latents"):
        synthesize_style_fast(gen, torch.zeros(2, 64), None, params)


def test_adain_launches_are_the_counted_shapes(monkeypatch):
    """Both paths call the MAT norm once per counted (r, C) a pass, with γ
    and β at pixel stride 0 and ε 1e-8."""
    seen = []
    real = sg.fused_mat_norm

    def spy(x, gamma, beta, eps=1e-5, **kw):
        assert gamma.stride()[1:3] == beta.stride()[1:3] == (0, 0) and eps == 1e-8
        seen.append((x.shape[1], x.shape[3]))
        return real(x, gamma, beta, eps, **kw)

    monkeypatch.setattr(sg, "fused_mat_norm", spy)
    gen = port_generator(TINY, seeded_weights(TINY))
    with torch.no_grad():
        gen(latents(2))
    synthesize_style_fast(gen, latents(2))
    want = style_counts.norm_shapes(TINY)
    assert style_counts.launches(TINY) == 8 and style_counts.launches(CONFIG["G"]) == 18
    for part in (seen[:8], seen[8:]):
        got = {}
        for s in part:
            got[s] = got.get(s, 0) + 1
        assert got == want


def test_model_flops_match_the_flop_counter():
    G = CONFIG["G"]
    W = {k: torch.empty(shape, device="meta") for k, (shape, _) in ref.param_spec(G).items()}
    W["dlatent_avg"] = torch.empty(512, device="meta")
    for batch in (1, 2):
        z = torch.empty(batch, 512, device="meta")
        noise = [torch.empty(batch, 1, r, r, device="meta") for _, _, r, _, _ in ref.layers(G)]
        with FlopCounterMode(display=False) as counter:
            ref.generator(W, G, z, noise, F32)
        assert style_counts.generator_forward(G, batch) == counter.get_total_flops()
    assert style_counts.generator_forward(G, 1) == 64_474_578_944


def test_adain_bound_counts_styles_not_maps():
    """The roofline's bytes: x read and out written once, and γ‖β as the
    2·B·C values they are."""
    assert style_counts.launch_bytes(32, 1024, 16, 2) == (2 * 32 * 1024 * 1024 * 16
                                                          + 2 * 32 * 16) * 2
    assert style_counts.bound_s(CONFIG["G"], 32, 2) == pytest.approx(2.5374e-3, rel=1e-4)


# -- the epilogue kernel's plain version ----------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_plain_version_is_noise_bias_and_leaky_relu(dtype):
    """``style_epilogue`` (its plain version here) is ``apply_noise``,
    ``apply_bias`` and the leaky ReLU of the official epilogue, in place."""
    g = torch.Generator().manual_seed(6)
    B, H, W, C = 2, 5, 7, 24
    x = (torch.randn(B, H, W, C, generator=g) * 2).to(dtype)
    noise = torch.randn(B, H, W, generator=g)
    strength, bias = (torch.randn(C, generator=g).to(dtype) for _ in range(2))
    nchw = lambda t: t.float().permute(0, 3, 1, 2)  # noqa: E731
    want = F.leaky_relu(nchw(x) + noise[:, None] * strength.float().view(1, -1, 1, 1)
                        + bias.float().view(1, -1, 1, 1), 0.2).permute(0, 2, 3, 1)
    y = x.clone()
    got = ck.style_epilogue(y, noise, strength, bias, 0.2)
    assert got is y and got.dtype == dtype
    if dtype == torch.float32:  # f32 throughout, the same sums in another order
        assert (got - want).abs().max() < 1e-5 * want.abs().max()
    else:  # computed in f32 and rounded once: within half a bf16 step (2^-8 relative)
        assert ((got.float() - want).abs() <= want.abs() * 2.0 ** -8 + 1e-6).all()
    with pytest.raises(ValueError, match="noise"):
        ck.style_epilogue(x, noise[:, :, :3], strength, bias)


@pytest.mark.parametrize("C,dtype,aligned,vec", [(16, torch.bfloat16, True, True),
                                                 (16, torch.float32, True, True),
                                                 (12, torch.bfloat16, True, False),
                                                 (512, torch.bfloat16, False, False)])
def test_epilogue_plan(C, dtype, aligned, vec):
    plan = ck.style_epilogue_plan(32 * 1024 * 1024 * C, C, dtype, aligned, 132)
    assert plan[0] == vec and plan[1] == ck.STYLE_BLOCKS_PER_SM * 132
    assert ck.style_epilogue_plan(2 * 16 * 16, 16, dtype, aligned, 132)[1] == 1


def test_epilogue_bound_counts_one_noise_value_a_pixel():
    assert style_counts.epilogue_bytes(32, 1024, 16, 2) == (
        (2 * 32 * 1024 * 1024 * 16 + 2 * 16) * 2 + 32 * 1024 * 1024 * 4)
    assert style_counts.epilogue_bound_s(CONFIG["G"], 32, 2) == pytest.approx(2.6441e-3,
                                                                             rel=1e-4)


# -- spans ----------------------------------------------------------------------------

def span_counts(prof) -> dict:
    out = {}
    for e in prof.events():
        if e.name.startswith(spans.PREFIX):
            out[e.name] = out.get(e.name, 0) + 1
    return out


@pytest.mark.parametrize("path", ["fast", "module"])
def test_spans_of_both_paths(path):
    gen, z = port_generator(TINY, seeded_weights(TINY)), latents(2)
    params = fuse_fast_params(gen)
    run = {"fast": lambda: synthesize_style_fast(gen, z, torch.Generator().manual_seed(1),
                                                 params),
           "module": lambda: gen(z, torch.Generator().manual_seed(1))}[path]
    with torch.no_grad():
        plain = run()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = run()
    assert torch.equal(plain, traced)
    n = span_counts(prof)
    assert n["s2p.gen.forward"] == n["s2p.style.mapping"] == n["s2p.gen.head"] == 1
    assert n["s2p.style.noise"] == n["s2p.style.adain"] == 8 and n["s2p.gen.upsample"] == 3
    assert all(n[f"s2p.gen.block_{i}"] == 1 for i in range(4)) and "s2p.gen.block_4" not in n


# -- the benchmark cell at a tiny size --------------------------------------------

def tiny_cell() -> harness.Cell:
    cell = harness.load_cell("stylegan-ffhq1024-b32")
    cell.config = dict(cell.config, precision="f32-tf32", G=TINY_FUSED,
                       weights=dict(cell.config["weights"], dlatent_avg_samples=256))
    cell.traffic = dict(cell.traffic, batch=4, pool=8, check_chunk=2, warmup_calls=1,
                        trace_calls=2)
    return cell


@pytest.fixture(scope="module")
def judged():
    cell = tiny_cell()
    ctx = harness.Ctx(cell, 2**33 + 11, CPU)
    prog = cell.driver.setup(ctx)
    for i in range(cell.traffic["judged_calls"]):
        prog.call(i)
    return cell, ctx, prog.finish()


def test_tiny_cell_run_is_correct():
    """A sound run judged by the cell's own limits: the program in f32 reads
    ~1e-6, far below limits set for bf16 at the full size."""
    res = harness.run_cell(tiny_cell(), 2**40 + 5, 0.3, False, CPU, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["checks"]["frame_max_gap"]["value"] < PATH_TOL
    assert res["metrics"]["gen_frames_per_s"]["value"] > 0 and res["attempted"] >= 1


@pytest.mark.parametrize("kind", ["fp8", "no_norm", "no_noise", "psi1"])
def test_tiny_cell_controls_are_not_correct(judged, kind):
    cell, ctx, calls = judged
    readings = cell.driver.control(ctx, calls, kind)
    assert not harness.judge(readings, cell.limits), readings


def test_tiny_cell_judges_what_the_calls_drew(judged):
    """Each judged call keeps its index, latents and frames, and its noise
    seed is the run's own: the reference draws the call's maps again."""
    cell, ctx, calls = judged
    assert len(calls["calls"]) == 2
    for i, z, frames in calls["calls"]:
        assert frames.shape == (4, 128, 128, 3) and z.shape == (4, 512)
    assert cell.driver.noise_seed(ctx, 0) != cell.driver.noise_seed(ctx, 1)
    assert cell.driver.check(ctx, calls)["frame_rms_gap"] < PATH_TOL
    assert math.isfinite(calls["weights"]["dlatent_avg"].sum().item())


# -- on a card --------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,C", [(64, 16), (32, 32), (256, 16)])
def test_kernel_with_styles_at_pixel_stride_zero(card, res, C, dtype):
    """The MAT-norm kernel as AdaIN (C = 16 and 32, resident and streaming)
    against its plain version, ε 1e-8, each launch a style launch."""
    g = torch.Generator(device=card).manual_seed(res + C)
    B = 3
    x = (torch.randn(B, res, res, C, generator=g, device=card) * 2 + 0.5).to(dtype)
    style = torch.randn(B, 2 * C, generator=g, device=card).to(dtype)
    gamma = style[:, :C].view(B, 1, 1, C).expand(B, res, res, C)
    beta = style[:, C:].view(B, 1, 1, C).expand(B, res, res, C)
    assert ck.forward_plan(x, gamma, beta).vec
    before = ck.fused_mat_norm.launches, ck.fused_mat_norm.style_launches
    with torch.no_grad():
        got = ck.fused_mat_norm(x, gamma, beta, eps=1e-8)
    want = ck.fused_mat_norm_plain(x, gamma, beta, eps=1e-8)
    torch.cuda.synchronize()
    assert (ck.fused_mat_norm.launches - before[0],
            ck.fused_mat_norm.style_launches - before[1]) == (1, 1)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,C", [(4, 512), (64, 256), (256, 16), (32, 12)])
def test_epilogue_kernel_matches_the_plain_version(card, res, C, dtype):
    """The style-epilogue kernel in place against its plain version (the
    vector path, and the scalar one at C = 12), one launch counted."""
    g = torch.Generator(device=card).manual_seed(res + C)
    B = 3
    x = (torch.randn(B, res, res, C, generator=g, device=card) * 2).to(dtype)
    noise = torch.randn(B, res, res, generator=g, device=card)
    strength, bias = (torch.randn(C, generator=g, device=card).to(dtype) for _ in range(2))
    want = ck.style_epilogue_plain(x, noise, strength, bias, 0.2)
    before = ck.style_epilogue.launches
    with torch.no_grad():
        got = ck.style_epilogue(x, noise, strength, bias, 0.2)
    torch.cuda.synchronize()
    assert got is x and ck.style_epilogue.launches - before == 1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
