"""GauGAN (``netG=spade``) in the port against the benchmark's plain reference
(``portbench/reference/spade.py``), on the CPU at a tiny width.

The tiny generator: ngf 8 (blocks 128 → 8 channels), 32×32 (latent 1×1),
9 classes + dontcare, nhidden 8, seeded weights in SPADE's own names
(spectral norm's ``weight_orig``/``weight_u``/``weight_v``, the batch norms'
running statistics). Float32 throughout; each tolerance says why it is
what it is. The SPADE-norm kernel runs only on the card (``chip_smoke.py
--spade`` holds it to its plain version there); here its plain version is
held to the reference's modulation.
"""

import copy
import json
import math
import time
from pathlib import Path

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, spans
from portbench.counts import spade as spade_counts
from portbench.reference import spade as ref
from portbench.reference.precision import Precision
from s2p_tpu_torch.gan import SPADEGenerator, fuse_fast_params, label_onehot, synthesize_fast
from s2p_tpu_torch.gan import cuda_kernels as ck
from s2p_tpu_torch.gan import generator as gen_mod
from s2p_tpu_torch.gan.convert import (diff_state_dict, load_generator_checkpoint,
                                       state_dict_from_spade)
from s2p_tpu_torch.gan.fast_inference import downsample_ids

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "spade-ade20k-256.json").read_text())
TINY = dict(CONFIG["opt"], ngf=8, crop_size=32, label_nc=9, nhidden=8)
F32 = Precision("f32")
CPU = torch.device("cpu")
# f32 on both sides, outputs in [-1, 1]: the paths differ only in the order of
# float operations (folded statistics, one wide shared conv, one-hot channels
# padded with zeros, the instance norm's shifted sums), ~1e-7 relative an
# operation, carried through ~20 layers whose norms rescale by up to ~10
PATH_TOL = 3e-5


def tiny_opt(norm_g="spectralspadesyncbatch3x3"):
    return dict(TINY, norm_G=norm_g)


def seeded_spade_weights(opt, seed=0) -> dict:
    """Weights in SPADE's names: convs from a seeded normal at variance
    1/fan-in, spectral norm's vectors by 5 power iterations, running
    statistics drawn away from (0, 1) so that folding them is tested."""
    g = torch.Generator().manual_seed(seed)
    W = {}
    for name, shape in ref.conv_spec(opt).items():
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 50
        W[name] = torch.randn(shape, generator=g) / math.sqrt(fan_in)
        if name.endswith(".weight_orig"):
            u0 = F.normalize(torch.randn(shape[0], generator=g), dim=0)
            base = name[: -len("_orig")]
            W[base + "_u"], W[base + "_v"] = ref.power_iteration(W[name], u0, 5)
    for name, width in ref.stat_names(opt).items():
        W[f"{name}.param_free_norm.running_mean"] = torch.randn(width, generator=g) * 0.3
        W[f"{name}.param_free_norm.running_var"] = torch.rand(width, generator=g) * 2 + 0.25
    return W


def port_generator(opt, W) -> SPADEGenerator:
    gen = SPADEGenerator(**opt, device="cpu")
    gen.load_state_dict(state_dict_from_spade(W), strict=True)
    return gen.eval().requires_grad_(False)


def label_ids(n=3, opt=TINY, seed=1):
    g = torch.Generator().manual_seed(seed)
    H = opt["crop_size"]
    return torch.randint(0, ref.semantic_nc(opt), (n, H, H), generator=g, dtype=torch.uint8)


def reference_frames(W, opt, ids, param_free=None):
    return ref.generator(W, opt, ref.onehot(ids, ref.semantic_nc(opt)), F32, param_free)


# -- the generator --------------------------------------------------------------

@pytest.mark.parametrize("norm_g", ["spectralspadesyncbatch3x3", "spadeinstance3x3"])
def test_module_and_fast_paths_match_the_reference(norm_g):
    opt = tiny_opt(norm_g)
    W = seeded_spade_weights(opt)
    gen, ids = port_generator(opt, W), label_ids()
    want = reference_frames(W, opt, ids)
    assert want.shape == (3, 32, 32, 3) and want.abs().max() > 0.1
    with torch.no_grad():
        module = gen(label_onehot(ids, gen.semantic_nc))
    fast = synthesize_fast(gen, ids)
    assert (module - want).abs().max() < PATH_TOL
    assert (fast - want).abs().max() < PATH_TOL
    # one fusion serves every call, and a second call renders the same frames
    params = fuse_fast_params(gen)
    assert torch.equal(synthesize_fast(gen, ids, params), synthesize_fast(gen, ids, params))


def test_generator_widths_follow_spade():
    gen = SPADEGenerator(**CONFIG["opt"], device="meta")
    assert gen.semantic_nc == 151 and gen.latent_hw == (8, 8) and gen.image_hw == (256, 256)
    assert [n for n, *_ in gen.schedule] == ["head_0", "G_middle_0", "G_middle_1", "up_0",
                                              "up_1", "up_2", "up_3"]
    assert gen.fc.weight.shape == (1024, 151, 3, 3) and gen.conv_img.weight.shape == (3, 64, 3, 3)
    assert sum(p.numel() for p in gen.parameters()) == 96_492_483
    for bad in (dict(use_vae=True), dict(no_instance=False), dict(norm_G="spectralspadebatch5x5"),
                dict(num_upsampling_layers="few")):
        with pytest.raises(ValueError):
            SPADEGenerator(**dict(CONFIG["opt"], **bad), device="meta")


@pytest.mark.parametrize("mode", ["more", "most"])
def test_deeper_upsampling_schedules_are_refused(mode):
    """Only SPADE's ``normal`` schedule is ported, in the port and the reference."""
    opt = dict(tiny_opt(), num_upsampling_layers=mode)
    with pytest.raises(ValueError):
        SPADEGenerator(**opt, device="meta")
    for fn in (ref.latent_hw, ref.schedule):
        with pytest.raises(ValueError):
            fn(opt)


def test_running_statistics_stay_float32_in_a_bf16_generator():
    gen = port_generator(tiny_opt(), seeded_spade_weights(tiny_opt())).to(torch.bfloat16)
    stats = [b for n, b in gen.named_buffers() if "running_" in n]
    assert len(stats) == 2 * 18 and all(b.dtype == torch.float32 for b in stats)
    assert gen.fc.weight.dtype == torch.bfloat16
    frames = synthesize_fast(gen, label_ids())
    assert frames.dtype == torch.bfloat16 and torch.isfinite(frames.float()).all()


# -- the kernel's plain version and the label maps ----------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_plain_version_is_the_reference_modulation(dtype):
    g = torch.Generator().manual_seed(4)
    B, H, W, C = 2, 5, 7, 24
    x = torch.randn(B, H, W, C, generator=g) * 3 + 1
    gb = torch.randn(B, H, W, 2 * C, generator=g)  # γ and β as the halves of one conv output
    mean, var = torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.1
    stats = gen_mod.RunningStats(C)
    stats.running_mean.copy_(mean)
    stats.running_var.copy_(var)
    a, b = stats.folded()
    x, gb = x.to(dtype), gb.to(dtype)
    got = ck.spade_norm(x, gb[..., :C], gb[..., C:], a, b)  # the CPU runs the plain version
    nchw = lambda t: t.float().permute(0, 3, 1, 2)
    want = (F.batch_norm(nchw(x), mean, var, training=False, eps=1e-5) * (1 + nchw(gb[..., :C]))
            + nchw(gb[..., C:])).permute(0, 2, 3, 1)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:  # f32 throughout: rsqrt folded against a division
        assert (got - want).abs().max() < 1e-5 * want.abs().max()
    else:  # computed in f32 and rounded once: within half a bf16 step (2^-8 relative)
        assert ((got.float() - want).abs() <= want.abs() * 2.0 ** -8 + 1e-6).all()


@pytest.mark.parametrize("hw,to", [((32, 32), (8, 8)), ((32, 32), (32, 32)), ((24, 16), (3, 4)),
                                   ((256, 256), (16, 16))])
def test_nearest_downsample_of_the_onehot_is_the_onehot_of_the_downsampled_ids(hw, to):
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 10, (2, *hw), generator=g)
    onehot = label_onehot(ids, 10)
    assert torch.equal(onehot, ref.onehot(ids, 10))
    assert torch.equal(F.interpolate(onehot, size=to, mode="nearest"),
                       label_onehot(downsample_ids(ids, to), 10))


def test_norm_launches_are_the_counted_shapes(monkeypatch):
    """Both paths call the SPADE-norm kernel once per counted (H, W, C) a pass."""
    seen = []
    real = gen_mod.spade_norm

    def spy(x, gamma, beta, scale, shift):
        seen.append(tuple(x.shape[1:]))
        return real(x, gamma, beta, scale, shift)

    monkeypatch.setattr(gen_mod, "spade_norm", spy)
    opt = tiny_opt()
    gen, ids = port_generator(opt, seeded_spade_weights(opt)), label_ids(n=2)
    with torch.no_grad():
        gen(label_onehot(ids, gen.semantic_nc))
    synthesize_fast(gen, ids)
    want = spade_counts.norm_shapes(opt)
    assert sum(want.values()) == spade_counts.launches(opt) == 18
    for part in (seen[:18], seen[18:]):
        got = {}
        for s in part:
            got[s] = got.get(s, 0) + 1
        assert got == want
    assert spade_counts.norm_shapes(tiny_opt("spadeinstance3x3")) == {}


def test_model_flops_match_the_flop_counter():
    opt = CONFIG["opt"]
    W = {k: torch.empty(s, device="meta") for k, s in ref.conv_spec(opt).items()}
    for k, s in ref.conv_spec(opt).items():
        if k.endswith(".weight_orig"):
            base = k[: -len("_orig")]
            W[base + "_u"] = torch.empty(s[0], device="meta")
            W[base + "_v"] = torch.empty(math.prod(s[1:]), device="meta")
    for name, width in ref.stat_names(opt).items():
        for leaf in ("running_mean", "running_var"):
            W[f"{name}.param_free_norm.{leaf}"] = torch.empty(width, device="meta")
    for batch in (1, 2):
        seg = torch.empty(batch, 151, 256, 256, device="meta")
        with FlopCounterMode(display=False) as counter:
            ref.generator(W, opt, seg, F32)
        assert spade_counts.generator_forward(opt, batch) == counter.get_total_flops()
    assert spade_counts.generator_forward(opt, 1) == 362_300_145_664


# -- SPADE's own checkpoint ---------------------------------------------------------

class TwinSPADE(nn.Module):
    """``normalization.py::SPADE`` with torch's own modules."""

    def __init__(self, norm_nc, label_nc, nhidden):
        super().__init__()
        self.param_free_norm = nn.BatchNorm2d(norm_nc, affine=False)
        self.mlp_shared = nn.Sequential(nn.Conv2d(label_nc, nhidden, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, 3, padding=1)

    def forward(self, x, seg):
        actv = self.mlp_shared(F.interpolate(seg, size=x.shape[2:], mode="nearest"))
        return self.param_free_norm(x) * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class TwinBlock(nn.Module):
    """``architecture.py::SPADEResnetBlock`` with ``spectral_norm``."""

    def __init__(self, fin, fout, opt):
        super().__init__()
        sn, fmid = nn.utils.spectral_norm, min(fin, fout)
        self.conv_0 = sn(nn.Conv2d(fin, fmid, 3, padding=1))
        self.conv_1 = sn(nn.Conv2d(fmid, fout, 3, padding=1))
        snc, nh = ref.semantic_nc(opt), opt["nhidden"]
        self.norm_0, self.norm_1 = TwinSPADE(fin, snc, nh), TwinSPADE(fmid, snc, nh)
        if fin != fout:
            self.conv_s = sn(nn.Conv2d(fin, fout, 1, bias=False))
            self.norm_s = TwinSPADE(fin, snc, nh)

    def forward(self, x, seg):
        lrelu = lambda t: F.leaky_relu(t, 0.2)
        xs = self.conv_s(self.norm_s(x, seg)) if hasattr(self, "conv_s") else x
        return xs + self.conv_1(lrelu(self.norm_1(self.conv_0(lrelu(self.norm_0(x, seg))), seg)))


class TwinGenerator(nn.Module):
    """``generator.py::SPADEGenerator`` (non-VAE, ``normal``)."""

    def __init__(self, opt):
        super().__init__()
        nf = opt["ngf"]
        self.sh, self.sw = ref.latent_hw(opt)
        self.fc = nn.Conv2d(ref.semantic_nc(opt), 16 * nf, 3, padding=1)
        for name, fin, fout, _ in ref.schedule(opt):
            self.add_module(name, TwinBlock(fin, fout, opt))
        self.conv_img = nn.Conv2d(nf, 3, 3, padding=1)
        self.schedule = ref.schedule(opt)

    def forward(self, seg):
        x = self.fc(F.interpolate(seg, size=(self.sh, self.sw)))
        for name, _, _, up in self.schedule:
            if up:
                x = F.interpolate(x, scale_factor=2)
            x = getattr(self, name)(x, seg)
        return torch.tanh(self.conv_img(F.leaky_relu(x, 2e-1))).permute(0, 2, 3, 1)


def trained_twin(opt) -> TwinGenerator:
    """A twin whose spectral norm's vectors and batch norms' statistics have
    moved: three train-mode passes (one power iteration each), then eval."""
    torch.manual_seed(6)
    twin = TwinGenerator(opt)
    with torch.no_grad():
        for seed in (7, 8, 9):
            twin(ref.onehot(label_ids(n=4, opt=opt, seed=seed), ref.semantic_nc(opt)))
    return twin.eval()


def test_spade_checkpoint_loads_and_renders_the_twins_frames(tmp_path):
    opt = tiny_opt()
    twin = trained_twin(opt)
    sd = twin.state_dict()
    assert {"head_0.conv_0.weight_orig", "head_0.conv_0.weight_u", "head_0.conv_0.weight_v",
            "up_0.norm_s.mlp_shared.0.weight", "up_0.norm_s.param_free_norm.running_var",
            "up_0.norm_s.param_free_norm.num_batches_tracked"} <= set(sd)
    ids = label_ids(n=2, seed=10)
    seg = ref.onehot(ids, ref.semantic_nc(opt))
    with torch.no_grad():
        want = twin(seg)
    # the reference reads the checkpoint as it is (its departures: eval only)
    assert (ref.generator(dict(sd), opt, seg, F32) - want).abs().max() < PATH_TOL
    gen = port_generator(opt, sd)
    assert (synthesize_fast(gen, ids) - want).abs().max() < PATH_TOL
    # and from a .pth file, through the checkpoint loader's SPADE-layout attempt
    path = tmp_path / "latest_net_G.pth"
    torch.save(sd, path)
    loaded = load_generator_checkpoint(str(path), SPADEGenerator(**opt, device="cpu")).eval()
    with torch.no_grad():
        assert (loaded(seg) - want).abs().max() < PATH_TOL


def test_diff_reports_a_missing_and_an_extra_spade_key():
    opt = tiny_opt()
    sd = dict(trained_twin(opt).state_dict())
    template = SPADEGenerator(**opt, device="cpu").state_dict()
    assert diff_state_dict(state_dict_from_spade(sd), template)["ok"]
    del sd["up_1.norm_1.param_free_norm.running_mean"]
    sd["up_1.norm_2.mlp_gamma.weight"] = torch.zeros(1)
    report = diff_state_dict(state_dict_from_spade(sd), template)
    assert not report["ok"]
    assert report["missing"] == ["up_1.norm_1.param_free_norm.running_mean"]
    assert report["unexpected"] == ["up_1.norm_2.mlp_gamma.weight"]
    del sd["up_1.conv_0.weight_v"]  # spectral norm without its vector: left unfolded
    report = diff_state_dict(state_dict_from_spade(sd), template)
    assert "up_1.conv_0.weight" in report["missing"]
    assert "up_1.conv_0.weight_orig" in report["unexpected"]


# -- spans --------------------------------------------------------------------------

def span_counts(prof) -> dict:
    out = {}
    for e in prof.events():
        if e.name.startswith(spans.PREFIX):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def test_spans_of_both_paths():
    opt = tiny_opt()
    gen, ids = port_generator(opt, seeded_spade_weights(opt)), label_ids(n=2)
    params = fuse_fast_params(gen)
    plain = synthesize_fast(gen, ids, params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = synthesize_fast(gen, ids, params)
    assert torch.equal(plain, traced)
    n = span_counts(prof)
    # one map per resolution (1, 2, 4, 8, 16, 32); one shared conv per block; 18 norms
    assert n["s2p.spade.onehot"] == n["s2p.spade.seg"] == 6
    assert n["s2p.mat.hidden"] == 7 and n["s2p.mat.gb"] == n["s2p.mat.norm"] == 18
    assert n["s2p.gen.forward"] == n["s2p.gen.embed"] == n["s2p.gen.head"] == 1
    assert n["s2p.gen.upsample"] == 5 and all(n[f"s2p.gen.block_{i}"] == 1 for i in range(7))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        gen(label_onehot(ids, gen.semantic_nc))
    n = span_counts(prof)  # the module path resizes the map for each norm, and for fc
    assert n["s2p.spade.seg"] == 19 and n["s2p.mat.hidden"] == n["s2p.mat.norm"] == 18
    assert "s2p.spade.onehot" not in n


# -- the benchmark cell at a tiny size --------------------------------------------

def tiny_cell() -> harness.Cell:
    cell = harness.load_cell("spade-ade256-b32")
    cell.config = dict(cell.config, precision="f32-tf32", opt=tiny_opt(),
                       weights=dict(cell.config["weights"], stat_batch=2))
    cell.traffic = dict(cell.traffic, batch=4, pool=8, check_chunk=4, warmup_calls=1,
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
    ~1e-5, far below limits set for bf16 at the full size."""
    res = harness.run_cell(tiny_cell(), 2**40 + 5, 0.3, False, CPU, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["gen_frames_per_s"]["value"] > 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"frame_max_gap", "frame_rms_gap"}


@pytest.mark.parametrize("kind", ["fp8", "no_norm", "label_shift"])
def test_tiny_cell_controls_are_not_correct(judged, kind):
    cell, ctx, calls = judged
    report = {}
    readings = cell.driver.control(ctx, calls, kind, report)
    assert not harness.judge(readings, cell.limits), readings
    assert 0 <= report["saturated_share"] < 0.1


def test_tiny_cell_label_maps_are_seeded_voronoi_partitions(judged):
    cell, ctx, calls = judged
    g = lambda: torch.Generator().manual_seed(3)
    maps = cell.driver.label_maps(4, (32, 32), 151, (8, 32), 1.0, g(), CPU)
    assert torch.equal(maps, cell.driver.label_maps(4, (32, 32), 151, (8, 32), 1.0, g(), CPU))
    assert maps.dtype == torch.uint8 and int(maps.max()) < 151
    for m in maps:
        assert 1 <= len(torch.unique(m)) <= 32
    frames = [f for _, f in calls["calls"]]
    assert len(frames) == 2 and frames[0].shape == (4, 32, 32, 3)
    weights = copy.copy(calls["weights"])
    assert "head_0.conv_0.weight_u" in weights and "fc.weight" in weights
