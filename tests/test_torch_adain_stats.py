"""StyleGAN's fast-path AdaIN in one pass over x: the style epilogue's
statistics variant (``cuda_kernels.style_epilogue_stats``) writes each pixel
range's partial statistics of the values it stores, and the MAT norm given
them (``fused_mat_norm(..., stats=)``) only normalises and modulates.

On the CPU both run their plain versions, on the kernels' partition and in
the norm's merge order (``style_stats_plain``, ``merge_stats_plain``,
``fused_mat_norm_stats_plain``): held here to f64 statistics and to the
two-pass norm. The kernels themselves are held to these on the card
(``cuda``-marked cases, ``chip_smoke.py --stylegan``)."""

import json
from pathlib import Path

import pytest
import torch

from portbench.counts import stylegan as style_counts
from s2p_tpu_torch.gan import StyleGANGenerator, fuse_fast_params, synthesize_style_fast
from s2p_tpu_torch.gan import cuda_kernels as ck
from s2p_tpu_torch.gan import fast_inference as fi
from s2p_tpu_torch.gan import stylegan as sg

# the merged statistics against f64 over the same values: f32 sums of shifted values,
# then Chan's merge; ~1e-7 seen, 1e-6 leaves room and still fails E[x²] − mean² at
# |mean| / std = 1e3 (~1e-1 there)
STATS_TOL = 1e-6
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # chip_smoke's F32_TOL, BF16_TOL
STYLEGAN_G = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                         / "stylegan-ffhq-1024.json").read_text())["G"]  # the cell's generator


def gaps(stats, y) -> tuple:
    """(|mean − mean₆₄| ÷ (|mean₆₄| + std₆₄), |var ÷ var₆₄ − 1|), the widest
    over images and channels, of the merged ``stats`` of y against y's own."""
    B, H, W, C = y.shape
    mean, m2 = ck.merge_stats_plain(stats, H * W)
    var64, mean64 = torch.var_mean(y.double().reshape(B, H * W, C), dim=1, unbiased=False)
    return (((mean.double() - mean64).abs() / (mean64.abs() + var64.sqrt())).max().item(),
            (m2.double() / (H * W) / var64 - 1).abs().max().item())


def plane(B, H, W, C, mean=0.5, std=2.0, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, W, C, generator=g) * std + mean).to(dtype)


# -- the partial statistics ------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (B, H, W, C, parts, mean, std, dtype)
    (2, 7, 9, 8, 5, 0.5, 2.0, torch.float32),  # ranges of 13, 13, 13, 13 and 11 pixels
    (2, 4, 4, 8, 16, 0.5, 2.0, torch.float32),  # ranges of one pixel
    (2, 5, 5, 8, 25, 1e3, 1.0, torch.float32),  # one pixel each at |mean| >> std
    (3, 32, 32, 16, 31, 1e3, 1.0, torch.float32),  # 30 ranges of 34 and one of 4
    (2, 64, 64, 16, 7, -3.0, 0.01, torch.float32),
    (2, 16, 16, 32, 3, 0.5, 2.0, torch.bfloat16),  # the values as bf16 stores them
    (1, 1, 1, 8, 1, 0.5, 2.0, torch.float32),  # a one-pixel plane: variance 0
], ids=["uneven", "one-pixel-ranges", "one-pixel-far-mean", "31-ranges-far-mean", "narrow",
        "bf16", "one-pixel-plane"])
def test_partials_merge_to_the_f64_statistics(case):
    B, H, W, C, parts, mean, std, dtype = case
    y = plane(B, H, W, C, mean, std, dtype)
    stats = ck.style_stats_plain(y, parts)
    assert stats.shape == (B, parts, ck.STATS_SLOTS, C) and stats.dtype == torch.float32
    if H * W == 1:
        got_mean, m2 = ck.merge_stats_plain(stats, 1)
        assert torch.equal(got_mean, y.reshape(B, C).float()) and not m2.any()
        return
    mean_gap, var_gap = gaps(stats, y)
    assert mean_gap <= STATS_TOL and var_gap <= STATS_TOL, (mean_gap, var_gap)


def test_unshifted_sums_fail_where_the_shifted_ones_hold():
    """An f32 plane of mean 1e3 and std 1: E[x²] − mean² in f32 misses the
    variance by far more than the tolerance the partials meet."""
    B, H, W, C = 2, 32, 32, 16
    y = plane(B, H, W, C, mean=1e3, std=1.0)
    v = y.reshape(B, H * W, C)
    s1, s2 = v.sum(dim=1), v.square().sum(dim=1)
    n = H * W
    naive = torch.stack([torch.zeros_like(s1), s1 / n, s2 - s1 * (s1 / n)], dim=1)[:, None]
    assert gaps(naive, y)[1] > 100 * STATS_TOL
    assert gaps(ck.style_stats_plain(y, 4), y)[1] <= STATS_TOL


def test_ranges_cover_the_plane_in_order():
    for hw in (1, 2, 9, 63, 1024, 4 ** 10):
        for parts in range(1, min(hw, 40) + 1):
            if (parts - 1) * -(-hw // parts) >= hw:
                with pytest.raises(ValueError, match="empty"):
                    ck._part_ranges(hw, parts)
                continue
            ranges = ck._part_ranges(hw, parts)
            assert [p0 for p0, _ in ranges] == [sum(n for _, n in ranges[:k])
                                               for k in range(parts)]
            assert sum(n for _, n in ranges) == hw and min(n for _, n in ranges) >= 1


# -- the launch plans ---------------------------------------------------------------------

# the epilogue's ranges an image at batch 32: from 32² up a range of 32 or more pixels
# for each range, at most 33 (the cell's 1,056 CTAs) from 256² up
STYLEGAN_RANGES = {4: 1, 8: 1, 16: 2, 32: 5, 64: 11, 128: 22, 256: 33, 512: 33, 1024: 33}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("res,C", sorted(style_counts.norm_shapes(STYLEGAN_G)))
def test_plans_at_the_stylegan_shapes(res, C, dtype):
    """Every AdaIN shape of a pass at batch 32: the epilogue's ranges on the
    vector path, none empty, at most ``STATS_TARGET_CTAS`` CTAs over the
    batch; the norm's one-pass grid on the vector path, one channel tile, at
    most a CTA a range, so that the slots its CTAs re-read stay under a tenth
    of x's bf16 bytes (but for a one-range plane)."""
    B, hw = 32, res * res
    vec, parts = ck.style_stats_plan(B, hw, C, dtype, True)
    assert vec and parts == STYLEGAN_RANGES[res] and B * parts <= ck.STATS_TARGET_CTAS + B
    assert len(ck._part_ranges(hw, parts)) == parts
    plan = ck.adain_plan(B, hw, C, dtype, True, 132, parts)
    width = 16 // dtype.itemsize
    assert plan.vec and plan.c_tiles == 1 and plan.lanes == C // width
    assert plan.threads % plan.lanes == 0 and plan.threads <= ck.HIDDEN_THREADS
    assert plan.grid <= parts and parts * plan.grid <= max(1, hw // ck.STATS_SLOT_PIXELS)


def test_epilogue_plan_keeps_a_threads_channels():
    """The ranges' threads keep their channels: C / V must divide the block
    (16-byte vectors, or channels on the scalar path)."""
    assert ck.style_stats_plan(2, 64, 16, torch.bfloat16, True)[0] is True
    assert ck.style_stats_plan(2, 64, 16, torch.bfloat16, False)[0] is False
    for C, dtype, aligned in ((24, torch.bfloat16, True), (512, torch.bfloat16, False),
                              (12, torch.float32, True)):
        with pytest.raises(ValueError, match="divide"):
            ck.style_stats_plan(2, 64, C, dtype, aligned)
    with pytest.raises(ValueError, match="statistics"):
        ck.style_stats_plan(0, 64, 16, torch.bfloat16, True)


# -- the epilogue and the norm, plain --------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,C", [(2, 4, 64), (3, 16, 32), (2, 64, 16)])
def test_stats_norm_equals_the_two_pass_norm(B, H, C, dtype):
    """The epilogue's statistics variant writes what ``style_epilogue`` writes
    and returns the statistics of it; the norm given them equals
    ``fused_mat_norm_plain`` on the same x."""
    g = torch.Generator().manual_seed(H + C)
    x = (torch.randn(B, H, H, C, generator=g) * 2 + 0.5).to(dtype)
    noise = torch.randn(B, H, H, generator=g)
    strength, bias = (torch.randn(C, generator=g).to(dtype) for _ in range(2))
    style = torch.randn(B, 2 * C, generator=g).to(dtype)
    gamma = style[:, :C].view(B, 1, 1, C).expand(B, H, H, C)
    beta = style[:, C:].view(B, 1, 1, C).expand(B, H, H, C)
    want = ck.style_epilogue(x.clone(), noise, strength, bias, 0.2)
    y = x.clone()
    stats = ck.style_epilogue_stats(y, noise, strength, bias, 0.2)
    assert torch.equal(y, want)
    assert stats.shape[1] == ck.style_stats_plan(B, H * H, C, dtype, True)[1]
    assert max(gaps(stats, y)) <= STATS_TOL
    got = ck.fused_mat_norm(y, gamma, beta, 1e-8, stats=stats)
    ref = ck.fused_mat_norm_plain(y, gamma, beta, 1e-8)
    tol = NORM_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def test_wrong_statistics_break_the_tolerance():
    """The norm's comparison can tell: another image's statistics, and those
    of half the plane, each fail it on planes with an offset an image and a
    ramp down the plane."""
    B, H, C = 3, 16, 16
    g = torch.Generator().manual_seed(5)
    ramp = torch.linspace(-2, 2, H * H).view(1, H, H, 1)
    y = torch.randn(B, H, H, C, generator=g) * 2 + ramp + torch.randn(B, 1, 1, C, generator=g) * 2
    style = torch.randn(B, 2 * C, generator=g)
    gamma = style[:, :C].view(B, 1, 1, C).expand(B, H, H, C)
    beta = style[:, C:].view(B, 1, 1, C).expand(B, H, H, C)
    stats = ck.style_stats_plain(y, 4)
    ref = ck.fused_mat_norm_plain(y, gamma, beta, 1e-8)
    half = ck.style_stats_plain(y[:, :H // 2].contiguous(), 2)
    mh, m2h = ck.merge_stats_plain(half, H * H // 2)
    for bad in (stats.roll(1, dims=0), torch.stack([mh, torch.zeros_like(mh), 2 * m2h], 1)[:, None]):
        got = ck.fused_mat_norm_stats_plain(y, gamma, beta, bad.contiguous(), 1e-8)
        assert not torch.allclose(got, ref, rtol=NORM_TOL[torch.float32],
                                  atol=NORM_TOL[torch.float32])


def test_stats_operands_are_checked():
    B, H, C = 2, 8, 16
    y = plane(B, H, H, C)
    style = torch.randn(B, 2 * C)
    gamma = style[:, :C].view(B, 1, 1, C).expand(B, H, H, C)
    beta = style[:, C:].view(B, 1, 1, C).expand(B, H, H, C)
    stats = ck.style_stats_plain(y, 2)
    with pytest.raises(ValueError, match="pixel stride 0"):
        ck.fused_mat_norm(y, torch.randn(B, H, H, C), beta, stats=stats)
    with pytest.raises(ValueError, match="gb_bias"):
        ck.fused_mat_norm(y, gamma, beta, gb_bias=torch.zeros(2 * C), stats=stats)
    with pytest.raises(ValueError, match="stats must be"):
        ck.fused_mat_norm(y, gamma, beta, stats=stats[:, :, :2].contiguous())
    with pytest.raises(ValueError, match="empty"):  # 63 ranges of 2 pixels: 64 pixels run out
        ck.fused_mat_norm(y, gamma, beta, stats=torch.zeros(B, H * H - 1, 3, C))
    x = y.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ck.fused_mat_norm(x, gamma, beta, stats=stats)
    noise = torch.randn(B, H, H)
    with pytest.raises(RuntimeError, match="no backward"):
        ck.style_epilogue_stats(x, noise, torch.zeros(C), torch.zeros(C))


# -- the paths --------------------------------------------------------------------------------

def test_fast_path_hands_the_epilogue_statistics_to_the_norm(monkeypatch):
    """Every layer of a fast pass runs the statistics epilogue and the norm
    with its statistics (8 at 32²: the kernels' ``stats_launches`` on the
    card, 18 at 1024²); the module path runs neither. On the CPU nothing
    launches, so the counters stay 0 and the calls are counted here."""
    calls = {"epilogue": 0, "stats_norm": 0, "norm": 0}
    real_epilogue, real_norm = ck.style_epilogue_stats, sg.fused_mat_norm
    handed = []

    def epilogue(*a, **kw):
        calls["epilogue"] += 1
        handed.append(real_epilogue(*a, **kw))
        return handed[-1]

    def norm(x, gamma, beta, eps=1e-5, **kw):
        calls["norm"] += 1
        if kw.get("stats") is not None:
            assert kw["stats"] is handed[-1]
            calls["stats_norm"] += 1
        return real_norm(x, gamma, beta, eps, **kw)

    monkeypatch.setattr(fi, "style_epilogue_stats", epilogue)
    monkeypatch.setattr(sg, "fused_mat_norm", norm)
    gen = StyleGANGenerator(resolution=32, fmap_max=64, device="cpu").requires_grad_(False)
    z = torch.randn(2, 512, generator=torch.Generator().manual_seed(1))
    ck.fused_mat_norm.stats_launches = ck.style_epilogue.stats_launches = 0
    fast = synthesize_style_fast(gen, z, torch.Generator().manual_seed(2), fuse_fast_params(gen))
    assert calls == {"epilogue": 8, "stats_norm": 8, "norm": 8}
    with torch.no_grad():
        module = gen(z, torch.Generator().manual_seed(2))
    assert calls == {"epilogue": 8, "stats_norm": 8, "norm": 16}
    assert ck.fused_mat_norm.stats_launches == ck.style_epilogue.stats_launches == 0
    # f32 on both sides; the statistics' order of sums is all that differs here
    assert ((fast - module).abs().max() / (module.max() - module.min())) < 2e-5


# -- on a card -------------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,C", [(4, 512), (64, 256), (256, 64), (1024, 16)])
def test_kernels_match_their_plain_versions(card, res, C, dtype):
    g = torch.Generator(device=card).manual_seed(res + C)
    B = 2
    x = (torch.randn(B, res, res, C, generator=g, device=card) * 2 + 0.5).to(dtype)
    noise = torch.randn(B, res, res, generator=g, device=card)
    strength, bias = (torch.randn(C, generator=g, device=card).to(dtype) for _ in range(2))
    style = torch.randn(B, 2 * C, generator=g, device=card).to(dtype)
    gamma = style[:, :C].view(B, 1, 1, C).expand(B, res, res, C)
    beta = style[:, C:].view(B, 1, 1, C).expand(B, res, res, C)
    want = ck.style_epilogue_plain(x, noise, strength, bias, 0.2)
    before = (ck.style_epilogue.launches, ck.style_epilogue.stats_launches,
              ck.fused_mat_norm.launches, ck.fused_mat_norm.stats_launches)
    with torch.no_grad():
        stats = ck.style_epilogue_stats(x, noise, strength, bias, 0.2)
        got = ck.fused_mat_norm(x, gamma, beta, 1e-8, stats=stats)
    torch.cuda.synchronize()
    after = (ck.style_epilogue.launches, ck.style_epilogue.stats_launches,
             ck.fused_mat_norm.launches, ck.fused_mat_norm.stats_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1, 1)
    tol = NORM_TOL[dtype]
    torch.testing.assert_close(x.float(), want.float(), rtol=tol, atol=tol)
    assert max(gaps(stats, x)) <= 10 * STATS_TOL  # ~250 sequential f32 sums a thread
    ref = ck.fused_mat_norm_plain(x, gamma, beta, 1e-8)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_counters_on_the_fast_and_the_module_path(card):
    """A fast pass at 1024² (batch 1, f32, as the module path takes f32
    latents): 18 statistics launches of each kernel; the module path none."""
    gen = StyleGANGenerator(device=card).requires_grad_(False)
    z = torch.randn(1, 512, device=card)
    ck.fused_mat_norm.stats_launches = ck.style_epilogue.stats_launches = 0
    synthesize_style_fast(gen, z)
    torch.cuda.synchronize()
    assert ck.fused_mat_norm.stats_launches == ck.style_epilogue.stats_launches == 18
    with torch.no_grad():
        gen(z)
    torch.cuda.synchronize()
    assert ck.fused_mat_norm.stats_launches == ck.style_epilogue.stats_launches == 18
