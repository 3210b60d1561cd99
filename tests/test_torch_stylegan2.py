"""StyleGAN2 config-f (NVlabs/stylegan2's ``G_main``, skip architecture) in the port
against the benchmark's plain reference (``portbench/reference/stylegan2.py``), on
the CPU at a tiny size.

The tiny generators keep every mechanism of FFHQ 1024² config-f: 8 mapping
layers of 512 with the gain after the activation, ψ on every dlatent toward
``dlatent_avg``, modulated and demodulated convs, scalar noise strengths, the
transposed up-convs with their [1, 3, 3, 1] FIR and the skip generator's
modulated toRGBs with the RGB upsample; at 32² with ``fmap_base`` 512 the
widths fall 256 → 32, at 64² with ``fmap_max`` 64 they stay 64. Weights are
seeded in the official variables' names, biases and noise strengths away
from 0, mod biases 0 (the official init). Float32 throughout; each
tolerance says why it is what it is. The epilogue kernel runs only on the
card (``cuda``-marked cases here, ``chip_smoke.py --stylegan2`` there); here
its plain version runs.
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
from portbench.counts import stylegan2 as counts2
from portbench.reference import stylegan2 as ref
from portbench.reference.precision import Precision
from s2p_tpu_torch.gan import (S2PGenerator, StyleGAN2Generator, StyleGANGenerator, fast_apply,
                               fuse_fast_params, synthesize_style_fast)
from s2p_tpu_torch.gan import cuda_kernels as ck
from s2p_tpu_torch.gan import fast_inference as fi
from s2p_tpu_torch.gan import stylegan as sg
from s2p_tpu_torch.gan import stylegan2 as sg2

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "stylegan2-ffhq-1024.json").read_text())
TINY = dict(CONFIG["G"], resolution=32, fmap_base=512)  # widths 256, 256, 128, 64, 32
TINY_WIDE = dict(CONFIG["G"], resolution=64, fmap_max=64)  # 64 channels at every resolution
F32 = Precision("f32")
CPU = torch.device("cpu")
# f32 on both sides: the paths differ only in the order of float operations (the fused
# per-image weights against x·s and ·d, ψ and dlatent_avg folded into one style GEMM, d
# from s² @ Σw², the toRGB as a batched GEMM), ~1e-7 relative an operation through up to
# 11 layers whose demodulation keeps the activations near unit scale; ÷ the frames' range
PATH_TOL = 1e-5


def seeded_weights(G, seed=0, noise=True) -> dict:
    """Weights in the official names: conv, toRGB and style weights N(0, 1)
    and mapping weights N(0, 1/lrmul²) as the official init draws them,
    biases N(0, 0.1²) at their run-time scale, mod biases 0, noise strengths
    N(0, 0.2²) (0 with ``noise`` False), the constant N(0, 1),
    ``dlatent_avg`` N(0, 0.3²)."""
    g = torch.Generator().manual_seed(seed)
    lrmul = G["mapping_lrmul"]
    std = {"mapping_weight": 1 / lrmul, "weight": 1.0, "mod_weight": 1.0, "const": 1.0,
           "mapping_bias": 0.1 / lrmul, "bias": 0.1, "mod_bias": 0.0,
           "noise": 0.2 if noise else 0.0}
    W = {name: torch.randn(shape, generator=g) * std[kind]
         for name, (shape, kind) in ref.param_spec(G).items()}
    W["dlatent_avg"] = torch.randn(G["dlatent_size"], generator=g) * 0.3
    return W


def port_generator(G, W) -> StyleGAN2Generator:
    gen = StyleGAN2Generator(**G, device="cpu")
    gen.load_state_dict({k.replace("/", "."): v for k, v in W.items()}, strict=True)
    return gen.eval().requires_grad_(False)


def latents(n=3, seed=1):
    return torch.randn(n, 512, generator=torch.Generator().manual_seed(seed))


def noise_gen(seed=9):
    return torch.Generator().manual_seed(seed)


def gap(a, b) -> float:
    return ((a - b).abs().max() / (b.max() - b.min())).item()


def reference(G, W, z, seed=9, **kw):
    return ref.generator(W, G, z, ref.noise_maps(len(z), G, noise_gen(seed), CPU), F32, **kw)


# -- the generator --------------------------------------------------------------

@pytest.mark.parametrize("G", [TINY, TINY_WIDE], ids=["32px", "64px"])
@pytest.mark.parametrize("noise", [True, False], ids=["noise", "no_noise"])
@pytest.mark.parametrize("psi", [0.5, 1.0])
def test_module_and_fast_paths_match_the_reference(psi, noise, G):
    """ψ 0.5 on every dlatent or 1; noise strengths drawn or 0; widths that
    fall with the resolution or stay."""
    G = dict(G, truncation_psi=psi)
    W = seeded_weights(G, noise=noise)
    gen, z = port_generator(G, W), latents()
    want = reference(G, W, z, use_noise=noise)
    R = G["resolution"]
    assert want.shape == (3, R, R, 3) and want.std() > 0.1
    with torch.no_grad():
        module = gen(z, noise_gen())
    fast = synthesize_style_fast(gen, z, noise_gen())
    assert gap(module, want) < PATH_TOL and gap(fast, want) < PATH_TOL
    assert gap(fast, module) < PATH_TOL
    params = fuse_fast_params(gen)  # one fusion serves every call, with the same noise
    assert torch.equal(synthesize_style_fast(gen, z, noise_gen(), params),
                       synthesize_style_fast(gen, z, noise_gen(), params))
    if noise:  # the noise is there: another draw moves the frames
        assert gap(synthesize_style_fast(gen, z, noise_gen(10), params), want) > 100 * PATH_TOL


@pytest.mark.parametrize("control", ["no_demod", "no_noise", "psi1", "nearest"])
def test_each_control_breaks_the_comparison(control):
    """The reference without demodulation, with every noise strength
    zeroed, at ψ = 1, or with nearest upsampling in place of the FIR is far
    outside the paths' agreement (at least 1,000 × ``PATH_TOL``)."""
    G = TINY
    W = seeded_weights(G)
    gen, z = port_generator(G, W), latents()
    kw = dict(no_demod=dict(demodulate=False), no_noise=dict(use_noise=False),
              psi1=dict(psi=1.0), nearest=dict(fir_on=False))[control]
    other = reference(G, W, z, **kw)
    fast = synthesize_style_fast(gen, z, noise_gen())
    with torch.no_grad():
        module = gen(z, noise_gen())
    assert gap(fast, other) > 1000 * PATH_TOL and gap(module, other) > 1000 * PATH_TOL


def test_the_same_seeded_generator_draws_bit_equal_noise():
    """The port's per-layer draws (one layer at 4²) and the reference's
    list, from one seed: the same maps, bit for bit, in layer order; StyleGAN's
    resolutions (two layers at 4²) stay as they were."""
    g = torch.Generator().manual_seed(3)
    port = [sg.noise_map(4, i, g, CPU, StyleGAN2Generator.FIRST_LAYERS) for i in range(7)]
    want = ref.noise_maps(4, TINY, torch.Generator().manual_seed(3), CPU)
    assert [tuple(n.shape) for n in port] == [(4, 1, r, r) for r in (4, 8, 8, 16, 16, 32, 32)]
    assert len(want) == 7 and all(torch.equal(a, b) for a, b in zip(port, want))
    assert [sg.layer_res(i) for i in range(6)] == [4, 4, 8, 8, 16, 16]


def test_generator_widths_follow_config_f():
    G = CONFIG["G"]
    gen = StyleGAN2Generator(**G, device="meta")
    n = sum(p.numel() for p in gen.parameters())
    assert n == counts2.parameters(G) == CONFIG["parameters"] == 30_370_060
    assert gen.num_layers == 18 and len(gen.layers()) == 17 and len(gen.torgbs()) == 9
    assert [s[4] for s in gen.layer_specs][::2] == [512, 512, 512, 512, 512, 256, 128, 64, 32]
    assert [s[:3] for s in gen.layer_specs[:3]] == [
        ("4x4", "Conv", "conv"), ("8x8", "Conv0_up", "up"), ("8x8", "Conv1", "conv")]
    names = set(gen.state_dict())
    assert {k.replace("/", ".") for k in ref.param_spec(G)} | {"dlatent_avg"} == names
    shapes = {k: tuple(v.shape) for k, v in gen.state_dict().items()}
    assert shapes["G_synthesis.4x4.Const.const"] == (1, 512, 4, 4)
    assert shapes["G_synthesis.1024x1024.Conv0_up.weight"] == (32, 64, 3, 3)
    assert shapes["G_synthesis.1024x1024.Conv0_up.mod_weight"] == (64, 512)
    assert shapes["G_synthesis.1024x1024.Conv1.noise_strength"] == ()
    assert shapes["G_synthesis.1024x1024.ToRGB.weight"] == (3, 32, 1, 1)
    assert shapes["G_synthesis.4x4.ToRGB.mod_bias"] == (512,)
    assert all(gen.psi(i) == 0.5 for i in range(18))  # truncation_cutoff None: every dlatent
    assert CONFIG["reduced"] == [] and {"weights", "biases", "mod_biases", "noise_strengths",
                                        "dlatent_avg"} <= set(CONFIG["assumed"])
    with pytest.raises(ValueError, match="power of two"):
        StyleGAN2Generator(**dict(G, resolution=1000), device="meta")


def test_dlatent_avg_stays_float32_in_a_bf16_generator():
    gen = port_generator(TINY, seeded_weights(TINY)).to(torch.bfloat16)
    assert gen.dlatent_avg.dtype == torch.float32
    assert gen.G_synthesis.get_submodule("4x4.Conv").weight.dtype == torch.bfloat16
    frames = synthesize_style_fast(gen, latents(), noise_gen(2))
    assert frames.dtype == torch.bfloat16 and torch.isfinite(frames.float()).all()


def test_fast_operands():
    """One style GEMM for the 17 convs' (padded to the widest input) and the
    9 toRGBs' affines; one batched GEMM's operand for every d; the up-convs'
    kernels flipped and transposed; the scalar noise strength as a vector."""
    G = TINY
    gen = port_generator(G, seeded_weights(G))
    params = fuse_fast_params(gen)
    convs, width = gen.layer_specs, 256
    rgb_in = [gen.nf(r - 1) for r in range(2, 6)]
    assert params["width"] == width
    assert params["style"]["weight"].shape == (512, len(convs) * width + sum(rgb_in))
    assert params["demod"].shape == (len(convs), width, width)
    for lp, layer in zip(params["layers"], gen.layers()):
        w = layer.conv_weight()
        O, I = w.shape[:2]
        if lp["kind"] == "up":
            assert torch.allclose(lp["weight"], w.flip(2, 3).transpose(0, 1))
        assert torch.equal(lp["noise"], layer.noise_strength.expand(O))
    sq = params["demod"][3]
    w = gen.layers()[3].conv_weight()
    assert torch.allclose(sq[:w.shape[1], :w.shape[0]], w.square().sum((2, 3)).t())
    assert sq[w.shape[1]:].abs().sum() == 0 and sq[:, w.shape[0]:].abs().sum() == 0
    with pytest.raises(ValueError, match="float only"):
        fuse_fast_params(gen, gb_int8=True)
    with pytest.raises(ValueError, match="latents"):
        synthesize_style_fast(gen, torch.zeros(2, 64), None, params)
    with pytest.raises(TypeError, match="StyleGAN2Generator"):
        synthesize_style_fast(torch.nn.Linear(2, 2), latents())


def test_stylegan_mapping_and_style_operands_are_bit_equal_to_their_formulas():
    """StyleGAN keeps the He gain in the weight's scale: its shared mapping
    layer and fused operands compute what they computed before the gain
    became an argument, bit for bit."""
    gen = StyleGANGenerator(resolution=32, fmap_max=64, truncation_cutoff=4, device="cpu")
    x = torch.randn(3, 512, generator=torch.Generator().manual_seed(2))
    d = gen.G_mapping.Dense0
    old = F.leaky_relu(F.linear(x, d.weight * sg.runtime_coef(d.weight.shape, sg.GAIN, d.lrmul),
                                d.bias * d.lrmul), sg.LRELU)
    assert torch.equal(d(x), old)
    params = fuse_fast_params(gen)
    for (w, b), dense in zip(params["mapping"], gen.G_mapping.children()):
        want = (dense.weight.float() * sg.runtime_coef(dense.weight.shape, sg.GAIN,
                                                       dense.lrmul)).t()
        assert torch.equal(w, want) and torch.equal(b, dense.bias.float() * dense.lrmul)


def test_stylegan2_mapping_puts_the_gain_after_the_activation():
    d = sg.Dense(4, 3, 0.01, act_gain=True)
    with torch.no_grad():
        d.weight.normal_(0, 100)
        d.bias.normal_(0, 10)
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
    w = d.weight * (1 / 2.0 * 0.01)  # gain 1 / sqrt(fan_in 4) · lrmul
    want = F.leaky_relu(x @ w.t() + d.bias * 0.01, 0.2) * math.sqrt(2)
    assert torch.allclose(d(x), want, rtol=1e-6, atol=1e-6)


# -- up-sampling and demodulation against direct formulas ----------------------------

def direct_fir(x: torch.Tensor, k: torch.Tensor, up: int, pad0: int, pad1: int) -> torch.Tensor:
    """upfirdn_2d written out: zeros inserted after each value, zero pads,
    then Σ over the taps of the flipped kernel, one shifted slice a tap."""
    B, C, H, W = x.shape
    z = torch.zeros(B, C, H * up, W * up, dtype=x.dtype)
    z[:, :, ::up, ::up] = x
    z = F.pad(z, (pad0, pad1, pad0, pad1))
    kh, kw = k.shape
    Ho, Wo = z.shape[2] - kh + 1, z.shape[3] - kw + 1
    out = torch.zeros(B, C, Ho, Wo, dtype=x.dtype)
    kf = k.flip(0, 1)
    for i in range(kh):
        for j in range(kw):
            out += kf[i, j] * z[:, :, i:i + Ho, j:j + Wo]
    return out


def fir4() -> torch.Tensor:
    k = torch.tensor([1.0, 3.0, 3.0, 1.0], dtype=torch.float64)
    return torch.outer(k, k) / 64 * 4


@pytest.mark.parametrize("size", [1, 4, 5])
def test_upsample_2d_is_zero_insertion_and_the_fir(size):
    """``upsample_2d`` (the port's transposed form and the reference's
    upfirdn) is zero insertion, pads 2/1 and the FIR × 4: output 2r."""
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(size),
                    dtype=torch.float64)
    want = direct_fir(x, fir4(), 2, 2, 1)
    assert want.shape == (2, 3, 2 * size, 2 * size)
    assert torch.allclose(sg2.upsample_2d(x), want, rtol=1e-12, atol=1e-12)
    got = ref.upsample_2d(x, TINY, Precision("f32"))
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    # a constant map stays constant inside (the kernel's gain 4 over 4 phases), 3/4 at the edge
    flat = sg2.upsample_2d(torch.ones(1, 1, 4, 4, dtype=torch.float64))
    assert torch.allclose(flat[0, 0, 1:-1, 1:-1], torch.ones(6, 6, dtype=torch.float64))


@pytest.mark.parametrize("size,c_in,c_out", [(3, 2, 5), (4, 6, 3)])
def test_upsample_conv_2d_is_zero_insertion_a_conv_and_the_fir(size, c_in, c_out):
    """``upsample_conv_2d``: x with zeros inserted, pads 2 before and 1
    after, the 3×3 correlation with the kernel itself (what the official
    transposed conv of the flipped kernel computes, output 2r + 1), then the
    FIR × 4 with pads 1/1: output 2r. The port's, and the reference's (its
    grouped form, with s = 1 and no demodulation)."""
    g = torch.Generator().manual_seed(size + c_in)
    x = torch.randn(2, c_in, size, size, generator=g, dtype=torch.float64)
    w = torch.randn(c_out, c_in, 3, 3, generator=g, dtype=torch.float64)
    z = torch.zeros(2, c_in, 2 * size, 2 * size, dtype=torch.float64)
    z[:, :, ::2, ::2] = x
    conv = F.conv2d(F.pad(z, (2, 1, 2, 1)), w)
    assert conv.shape[-1] == 2 * size + 1
    want = direct_fir(conv, fir4(), 1, 1, 1)
    assert want.shape == (2, c_out, 2 * size, 2 * size)
    assert torch.allclose(sg2.upsample_conv_2d(x, w), want, rtol=1e-10, atol=1e-10)
    W = {"s/weight": w * math.sqrt(c_in * 9), "s/mod_weight": torch.zeros(c_in, 4, dtype=x.dtype),
         "s/mod_bias": torch.zeros(c_in, dtype=x.dtype)}
    got = ref.modulated_conv(W, TINY, "s", x, torch.zeros(2, 4, dtype=x.dtype), F32, up=True,
                             demodulate=False)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


def test_demodulation_coefficients_are_the_per_image_weights_norms():
    g = torch.Generator().manual_seed(5)
    w, s = torch.randn(6, 4, 3, 3, generator=g), torch.randn(3, 4, generator=g)
    want = torch.rsqrt((w[None] * s[:, None, :, None, None]).square().sum((2, 3, 4)) + 1e-8)
    assert torch.allclose(sg2.demod_coef(s, w), want, rtol=1e-6)


# -- the epilogue's plain version ----------------------------------------------------

def rgb_direct(act, rgb_w, bias, prev):
    """toRGB written out: Σ_c act·w per output channel, the bias, and
    ``direct_fir``'s upsample of the previous sum (zero insertion, pads 2/1)."""
    out = (act[..., None, :] * rgb_w[:, None, None]).sum(4) + torch.tensor(bias)
    if prev is not None:
        up = direct_fir(prev.permute(0, 3, 1, 2).double(), fir4(), 2, 2, 1)
        out = out + up.float().permute(0, 2, 3, 1)
    return out


@pytest.mark.parametrize("mode", ["fir", "rgb", "rgb_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_demod_epilogue_is_the_layer_epilogue(dtype, mode):
    """``style_demod_epilogue`` (its plain version here): the
    modulated conv's ·d, StyleGAN2's noise, bias, leaky ReLU and √2 gain, and
    the next conv's input scaling (``mod``), written to x; for an up layer
    (``fir``) of the FIR of the transposed conv's output (``direct_fir``,
    pads 1/1); for a layer that feeds toRGB (``rgb``) in place, with the new
    RGB sum: the modulated 1×1 toRGB, its bias and the previous sum
    upsampled, and x left as it was where no next conv reads it
    (``rgb_last``). d and the style are read as ``[B, C]`` views of wider
    rows (one value an image and channel, at pixel stride 0)."""
    g = torch.Generator().manual_seed(7)
    B, H, W, C = 2, 8, 6, 24
    src = (torch.randn(B, H + 1, W + 1, C, generator=g) * 2).to(dtype)
    x = (torch.randn(B, H, W, C, generator=g) * 2).to(dtype)
    noise = torch.randn(B, H, W, generator=g)
    strength = torch.full((C,), 0.3).to(dtype)  # a scalar strength as a vector
    bias = torch.randn(C, generator=g).to(dtype)
    rows = torch.rand(2, B, 32, generator=g) + 0.5
    demod, mod = rows[0, :, :C], rows[1, :, :C]
    assert demod.stride() == (32, 1)
    rgb_w, prev = torch.randn(B, 3, C, generator=g), torch.randn(B, H // 2, W // 2, 3, generator=g)
    f = lambda t: t.float()  # noqa: E731
    pre = (direct_fir(f(src).permute(0, 3, 1, 2).double(), fir4(), 1, 1, 1).float()
           .permute(0, 2, 3, 1) if mode == "fir" else f(x))
    t = pre * demod[:, None, None] + noise[..., None] * f(strength) + f(bias)
    want = F.leaky_relu(t, 0.2) * math.sqrt(2)
    y, rgb = x.clone(), torch.empty(B, H, W, 3)
    kw = dict(demod=demod, gain=math.sqrt(2), taps=sg2.fir_taps(),
              mod=None if mode == "rgb_last" else mod)
    if mode == "fir":
        kw["fir_src"] = src
    if mode.startswith("rgb"):
        kw.update(rgb=rgb, rgb_w=rgb_w, rgb_bias=(0.1, -0.2, 0.3),
                  rgb_prev=prev if mode == "rgb" else None)
    assert ck.style_demod_epilogue(y, noise, strength, bias, slope=0.2, **kw) is y
    tol = (lambda v: 1e-5 * v.abs().max()) if dtype == torch.float32 else (  # noqa: E731
        lambda v: v.abs() * 2.0 ** -8 + 1e-6)  # rounded once from f32: half a bf16 step
    exp = want if kw["mod"] is None else want * mod[:, None, None]
    if mode == "rgb_last":
        assert torch.equal(y, x)
    else:
        assert ((f(y) - exp).abs() <= tol(exp)).all()
    if mode.startswith("rgb"):
        rgb_want = rgb_direct(want, rgb_w, kw["rgb_bias"], kw["rgb_prev"])
        assert (rgb - rgb_want).abs().max() < 1e-5 * rgb_want.abs().max()
    # each term shows: without d or the gain the result moves
    for drop in (dict(demod=torch.ones_like(demod)), dict(gain=1.0)):
        other = ck.style_epilogue_plain(x, noise, strength, bias, 0.2,
                                        **dict(dict(demod=demod, gain=math.sqrt(2)), **drop))
        assert (f(other) - F.leaky_relu(f(x) * demod[:, None, None] + noise[..., None]
                                        * f(strength) + f(bias), 0.2) * math.sqrt(2)
                ).abs().max() > 0.1


def test_fir_taps_make_the_fir_kernel():
    taps = torch.tensor(sg2.fir_taps(), dtype=torch.float64)
    assert torch.allclose(torch.outer(taps, taps), fir4())
    assert torch.allclose(sg2.fir_kernel(2, dtype=torch.float64)[1, 0], fir4())


def test_demod_epilogue_refuses_what_it_cannot_read():
    B, H, W, C = 2, 4, 4, 8
    x, noise = torch.randn(B, H, W, C), torch.randn(B, H, W)
    strength, bias, d = torch.zeros(C), torch.zeros(C), torch.ones(B, C)
    taps = sg2.fir_taps()
    epilogue = lambda demod=d, **kw: ck.style_demod_epilogue(x, noise, strength, bias,  # noqa: E731
                                                             demod, **kw)
    with pytest.raises(ValueError, match="demod must be float32"):
        epilogue(torch.ones(B, 2 * C)[:, ::2], taps=taps, fir_src=torch.randn(B, H + 1, W + 1, C))
    with pytest.raises(ValueError, match="one of them"):  # neither pass
        epilogue(mod=d, taps=taps)
    with pytest.raises(ValueError, match="fir_src must be"):
        epilogue(fir_src=torch.randn(B, H, W, C), taps=taps)
    with pytest.raises(ValueError, match="4 taps"):
        epilogue(fir_src=torch.randn(B, H + 1, W + 1, C), taps=taps[:3])
    with pytest.raises(ValueError, match="rgb_w must be"):
        epilogue(taps=taps, rgb=torch.empty(B, H, W, 3), rgb_w=torch.empty(B, 4, C),
                 rgb_bias=(0, 0, 0))
    with pytest.raises(ValueError, match="with mod"):  # an up layer feeds the next conv
        epilogue(taps=taps, fir_src=torch.randn(B, H + 1, W + 1, C))


def test_demod_epilogue_bound_counts_each_mode():
    px = 32 * 1024 ** 2
    assert counts2.epilogue_bytes(32, 1024, 32, 2, "last") == (
        (px * 32 + 2 * 32) * 2 + px * 4 + 32 * 32 * 4 + (32 * 32 + px + 32 * 512 ** 2) * 12)
    assert counts2.epilogue_bytes(32, 1024, 32, 2, "fir") == (
        ((32 * 1025 ** 2 + px) * 32 + 2 * 32) * 2 + px * 4 + 2 * 32 * 32 * 4)
    assert counts2.epilogue_bytes(2, 4, 8, 4, "rgb") == (
        (2 * 32 * 8 + 2 * 8) * 4 + 32 * 4 + 2 * 2 * 8 * 4 + (2 * 8 + 32) * 12)
    assert counts2.epilogue_flops(2, 4, 8, "fir") == (6 + 1 + 32) * 2 * 16 * 8
    assert counts2.epilogue_flops(2, 4, 8, "last") == (6 + 6) * 2 * 16 * 8
    modes = [m for *_, m in counts2.epilogue_shapes(CONFIG["G"])]
    assert modes == ["rgb"] + ["fir", "rgb"] * 7 + ["fir", "last"]
    assert counts2.epilogue_bound_s(CONFIG["G"], 32, 2) == pytest.approx(4.69526e-03, rel=1e-4)


# -- counts ---------------------------------------------------------------------------

def test_model_flops_match_the_flop_counter():
    G = CONFIG["G"]
    W = {k: torch.empty(shape, device="meta") for k, (shape, _) in ref.param_spec(G).items()}
    W["dlatent_avg"] = torch.empty(512, device="meta")
    for batch in (1, 2):
        z = torch.empty(batch, 512, device="meta")
        noise = [torch.empty(batch, 1, r, r, device="meta") for _, _, r, *_ in
                 ref.conv_layers(G)]
        with FlopCounterMode(display=False) as counter:
            ref.generator(W, G, z, noise, F32)
        assert counts2.generator_forward(G, batch) == counter.get_total_flops()
    assert counts2.generator_forward(G, 1) == 150_770_399_232


# -- launches -----------------------------------------------------------------------

class Spy:
    """Counts the calls of a wrapper as the card counts its launches."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def test_launch_counts_of_each_family(monkeypatch):
    """StyleGAN2's fast pass: one demodulating epilogue a conv layer (17 at
    1024²) and no MAT norm; StyleGAN's: one statistics epilogue a layer (18
    at 1024²) and none demodulating; S2P's fast and module paths: none."""
    epilogue, demod = Spy(ck.style_epilogue_stats), Spy(ck.style_demod_epilogue)
    norm = Spy(sg.fused_mat_norm)
    monkeypatch.setattr(fi, "style_epilogue_stats", epilogue)
    monkeypatch.setattr(fi, "style_demod_epilogue", demod)
    monkeypatch.setattr(sg, "fused_mat_norm", norm)
    gen2 = port_generator(TINY, seeded_weights(TINY))
    synthesize_style_fast(gen2, latents(2))
    assert counts2.launches(TINY) == 7 and counts2.launches(CONFIG["G"]) == 17
    assert (norm.calls, epilogue.calls, demod.calls) == (0, 0, 7)
    gen1 = StyleGANGenerator(resolution=32, fmap_max=64, device="cpu").requires_grad_(False)
    synthesize_style_fast(gen1, latents(2))
    assert (norm.calls, epilogue.calls, demod.calls) == (8, 8, 7)  # StyleGAN: one a layer
    assert StyleGANGenerator(device="meta").num_layers == 18  # 18 at 1024², as before
    s2p = S2PGenerator(4, image_size=32, ngf=8, state_embed_dim=16, mat_hidden=8, device="cpu")
    with torch.no_grad():
        fast_apply(s2p, fuse_fast_params(s2p), torch.zeros(2, 4), torch.zeros(2, 32, 32, 3))
    assert (epilogue.calls, demod.calls) == (8, 7)


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
    run = {"fast": lambda: synthesize_style_fast(gen, z, noise_gen(1), params),
           "module": lambda: gen(z, noise_gen(1))}[path]
    with torch.no_grad():
        plain = run()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = run()
    assert torch.equal(plain, traced)
    n = span_counts(prof)
    assert n["s2p.gen.forward"] == n["s2p.style.mapping"] == 1
    assert n["s2p.style.noise"] == 7 and n["s2p.gen.upsample"] == 3
    assert n["s2p.style.skip"] == 4 and "s2p.style.adain" not in n
    # the fast path: one modulation span (the d GEMM, the constant's scaling); the module
    # path: one a modulated layer, toRGBs included
    assert n["s2p.style.modulate"] == (1 if path == "fast" else 11)
    assert all(n[f"s2p.gen.block_{i}"] == 1 for i in range(4)) and "s2p.gen.block_4" not in n


# -- the benchmark cell at a tiny size --------------------------------------------

def tiny_cell() -> harness.Cell:
    cell = harness.load_cell("stylegan2-ffhq1024-b32")
    cell.config = dict(cell.config, precision="f32-tf32", G=TINY,
                       weights=dict(cell.config["weights"], dlatent_avg_samples=256))
    cell.traffic = dict(cell.traffic, batch=4, pool=8, check_chunk=2, warmup_calls=1,
                        trace_calls=2)
    return cell


@pytest.fixture(scope="module")
def judged():
    cell = tiny_cell()
    ctx = harness.Ctx(cell, 2**33 + 17, CPU)
    prog = cell.driver.setup(ctx)
    for i in range(cell.traffic["judged_calls"]):
        prog.call(i)
    return cell, ctx, prog.finish()


def test_tiny_cell_run_is_correct():
    """A sound run judged by the cell's own limits: the program in f32 reads
    ~1e-6, far below limits set for bf16 at the full size."""
    res = harness.run_cell(tiny_cell(), 2**40 + 7, 0.3, False, CPU, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["checks"]["frame_max_gap"]["value"] < PATH_TOL
    assert res["metrics"]["gen_frames_per_s"]["value"] > 0 and res["attempted"] >= 1


@pytest.mark.parametrize("kind", ["fp8", "no_demod", "no_noise", "psi1", "nearest"])
def test_tiny_cell_controls_are_not_correct(judged, kind):
    cell, ctx, calls = judged
    readings = cell.driver.control(ctx, calls, kind)
    assert not harness.judge(readings, cell.limits), readings


def test_tiny_cell_judges_what_the_calls_drew(judged):
    cell, ctx, calls = judged
    assert len(calls["calls"]) == 2
    for i, z, frames in calls["calls"]:
        assert frames.shape == (4, 32, 32, 3) and z.shape == (4, 512)
    assert cell.driver.check(ctx, calls)["frame_rms_gap"] < PATH_TOL
    W = calls["weights"]
    assert math.isfinite(W["dlatent_avg"].sum().item())
    assert W["G_synthesis/8x8/Conv1/mod_bias"].abs().sum() == 0  # the official init
    assert W["G_synthesis/8x8/Conv1/noise_strength"].shape == ()


def test_traced_tiny_cell_reads_the_new_metrics():
    """A traced run's line: ``mfu.stylegan2``; the roofline and the
    modulation share need a device trace (None on the CPU, left out)."""
    cell = tiny_cell()
    res = harness.run_cell(cell, 2**36 + 3, 0.3, True, CPU, time.perf_counter())
    assert res["correct"] and res["metrics"]["mfu.stylegan2"]["value"] > 0
    assert {m["name"] for m in cell.per_layer} == {"mfu.stylegan2",
                                                   "style_epilogue_roofline.stylegan2",
                                                   "modulate_share.stylegan2"}


# -- on a card --------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,C,mode", [(4, 512, "rgb"), (64, 256, "fir"), (256, 64, "last"),
                                        (128, 128, "rgb"), (64, 32, "rgb"), (32, 12, "rgb"),
                                        (16, 12, "fir"), (8, 24, "last")])
def test_demod_epilogue_kernel_matches_the_plain_version(card, res, C, mode, dtype):
    """The demodulating kernel against its plain version in each mode: the
    vector path (with toRGB over 4 to 64 vectors a pixel, reduced in a warp
    or across warps), the scalar one at C = 12 and 24 (toRGB's
    per-lane adds); one launch counted in both counters."""
    g = torch.Generator(device=card).manual_seed(res + C)
    B = 3
    x = (torch.randn(B, res, res, C, generator=g, device=card) * 2).to(dtype)
    src = (torch.randn(B, res + 1, res + 1, C, generator=g, device=card) * 2).to(dtype)
    noise = torch.randn(B, res, res, generator=g, device=card)
    strength, bias = (torch.randn(C, generator=g, device=card).to(dtype) for _ in range(2))
    rows = torch.rand(2, B, 512, generator=g, device=card) + 0.5
    kw = dict(demod=rows[0, :, :C], gain=math.sqrt(2), taps=sg2.fir_taps(),
              mod=None if mode == "last" else rows[1, :, :C])
    if mode == "fir":
        kw["fir_src"] = src
    if mode in ("rgb", "last"):
        prev = torch.randn(B, res // 2, res // 2, 3, generator=g, device=card) if res > 4 else None
        kw.update(rgb=torch.empty(B, res, res, 3, device=card),
                  rgb_w=torch.randn(B, 3, C, generator=g, device=card) / C ** 0.5,
                  rgb_bias=(0.1, -0.2, 0.3), rgb_prev=prev)
    want, want_rgb = x.clone(), torch.empty(B, res, res, 3)
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in kw.items()}
    if "rgb" in cpu:
        cpu["rgb"] = want_rgb
    want = want.cpu()
    ck.style_demod_epilogue(want, noise.cpu(), strength.cpu(), bias.cpu(), slope=0.2, **cpu)
    before = ck.style_epilogue.launches, ck.style_epilogue.demod_launches
    with torch.no_grad():
        got = ck.style_demod_epilogue(x, noise, strength, bias, slope=0.2, **kw)
    torch.cuda.synchronize()
    assert got is x and (ck.style_epilogue.launches - before[0],
                         ck.style_epilogue.demod_launches - before[1]) == (1, 1)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(x.float().cpu(), want.float(), rtol=tol, atol=tol)
    if "rgb" in kw:  # f32 sums in another order over C channels of ~1
        torch.testing.assert_close(kw["rgb"].cpu(), want_rgb, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fast_path_on_the_card_counts_its_launches(card):
    """A tiny StyleGAN2 pass on the card: 7 demodulating epilogues and no
    MAT-norm launch; in f32 (TF32 off) its frames hold to the module path's
    on the card with the same noise."""
    gen = port_generator(TINY, seeded_weights(TINY)).to(card)
    z = latents(2).to(card)
    draw = lambda: torch.Generator(device=card).manual_seed(9)  # noqa: E731
    counters = lambda: (ck.fused_mat_norm.launches, ck.style_epilogue.launches,  # noqa: E731
                        ck.style_epilogue.demod_launches)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = counters()
        got = synthesize_style_fast(gen, z, draw())
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(counters(), before))
        with torch.no_grad():
            want = gen(z, draw())
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert launched == (0, 7, 7)
    assert gap(got.cpu(), want.cpu()) < PATH_TOL
