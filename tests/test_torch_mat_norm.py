"""The port's MAT norm (s2p_tpu_torch.gan.cuda_kernels) against the JAX
kernel module. On the CPU the wrapper runs its plain version, and JAX's
``fused_mat_norm`` runs ``_plain`` (as in test_pallas.py); f32, atol 1e-5.
The CUDA kernel itself is held to the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2p_tpu.gan.pallas_kernels import _plain
from s2p_tpu.gan.pallas_kernels import fused_mat_norm as jax_fused_mat_norm
from s2p_tpu_torch.gan.cuda_kernels import (
    _batch_pixel_strides,
    fused_mat_norm,
    fused_mat_norm_plain,
    spade_norm,
    spade_norm_plain,
)


def _xgb(shape, seed=0, mean=0.0):
    rs = np.random.RandomState(seed)
    x = (mean + rs.randn(*shape)).astype(np.float32)
    g = (0.5 * rs.randn(*shape)).astype(np.float32)
    b = (0.5 * rs.randn(*shape)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("C", [12, 64])
@pytest.mark.parametrize("hw", [4, 7, 13])  # H·W = 16, 49, 169
def test_mat_norm_matches_jax(hw, C):
    x, g, b = _xgb((2, hw, hw, C), seed=hw * C)
    out = fused_mat_norm(*map(torch.from_numpy, (x, g, b))).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_fused_mat_norm(x, g, b)), atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(_plain(jnp.asarray(x), g, b, 1e-5)), atol=1e-5)
    np.testing.assert_array_equal(out, fused_mat_norm_plain(
        *map(torch.from_numpy, (x, g, b))).numpy())


def test_mat_norm_strided_gamma_beta_views():
    """γ and β as the two channel halves of one [B,H,W,2C] tensor (the
    fast path's γ‖β conv output)."""
    x, _, _ = _xgb((2, 7, 7, 12), seed=1)
    gb = (0.5 * np.random.RandomState(2).randn(2, 7, 7, 24)).astype(np.float32)
    gb_t = torch.from_numpy(gb)
    g, b = gb_t[..., :12], gb_t[..., 12:]
    assert not g.is_contiguous() and _batch_pixel_strides(g, "gamma") == (7 * 7 * 24, 24)
    out = fused_mat_norm(torch.from_numpy(x), g, b).numpy()
    ref = np.asarray(_plain(jnp.asarray(x), gb[..., :12], gb[..., 12:], 1e-5))
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("hw", [4, 8])
def test_mat_norm_large_mean_small_std(hw):
    """|mean| ≫ std: 256 + k/64 with H·W a power of two, so the mean and the
    centred squares are exact in f32 and any two-pass variance agrees to
    1e-5, while E[x²] − mean² cancels (its error is asserted to be large)."""
    rs = np.random.RandomState(hw)
    x = (256.0 + rs.randint(-64, 65, size=(2, hw, hw, 12)) / 64.0).astype(np.float32)
    _, g, b = _xgb(x.shape, seed=hw)
    out = fused_mat_norm(*map(torch.from_numpy, (x, g, b))).numpy()
    ref = np.asarray(_plain(jnp.asarray(x), g, b, 1e-5))
    np.testing.assert_allclose(out, ref, atol=1e-5)
    mean = x.mean((1, 2), keepdims=True)
    naive_var = (x * x).mean((1, 2), keepdims=True) - mean * mean
    naive = (x - mean) / np.sqrt(np.maximum(naive_var, 0) + 1e-5) * (1 + g) + b
    assert np.abs(naive - ref).max() > 1e-3


def test_mat_norm_plain_keeps_bf16_and_computes_in_f32():
    x, g, b = (torch.from_numpy(a).to(torch.bfloat16) for a in _xgb((2, 4, 4, 12)))
    out = fused_mat_norm(x, g, b)
    assert out.dtype == torch.bfloat16
    ref = fused_mat_norm_plain(x.float(), g.float(), b.float()).to(torch.bfloat16)
    assert torch.equal(out, ref)


def test_stride_checks_reject_what_the_kernel_cannot_read():
    t = torch.zeros(2, 4, 4, 8)
    assert _batch_pixel_strides(t, "x") == (128, 8)
    with pytest.raises(ValueError, match="unit-stride"):
        _batch_pixel_strides(torch.zeros(2, 8, 4, 4).permute(0, 2, 3, 1), "gamma")
    with pytest.raises(ValueError, match="one strided pixel axis"):
        _batch_pixel_strides(t.transpose(1, 2), "beta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mat_norm(t.to("meta"), t.to("meta"), t.to("meta"))


# -- the γ‖β conv's bias, folded into either norm kernel (gb_bias) --------------

def _mat_before(x, g, b):
    """The MAT norm as computed before the fold: (x − μ)·rstd·(1 + γ) + β."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=(1, 2), keepdim=True) + 1e-5)
    return ((xf - mean) * rstd * (1.0 + g.float()) + b.float()).to(x.dtype)


# kernel → (wrapper, plain version, extra operands from a generator, the
# modulation as computed before the fold)
KERNELS = dict(
    mat=(fused_mat_norm, fused_mat_norm_plain, lambda C, gen: (),
         lambda x, g, b: _mat_before(x, g, b)),
    spade=(spade_norm, spade_norm_plain,
           lambda C, gen: (torch.rand(C, generator=gen) + 0.5, torch.randn(C, generator=gen)),
           lambda x, g, b, a, s: ((x.float() * a + s) * (1.0 + g.float()) + b.float()).to(
               x.dtype)),
)


def _with_bias(kernel, C, dtype, strided, seed=3):
    """x, γ, β, the kernel's extra operands (SPADE's folded f32 statistics)
    and a γ‖β bias [2C] in ``dtype``; γ and β as the two channel halves of
    one [B,H,W,2C] map when ``strided`` (the fast path's layout)."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(2, 5, 7, C, generator=gen) * 3 + 1).to(dtype)
    gb = (0.5 * torch.randn(2, 5, 7, 2 * C, generator=gen)).to(dtype)
    extra = KERNELS[kernel][2](C, gen)
    bias = (0.5 * torch.randn(2 * C, generator=gen)).to(dtype)
    g, b = (gb[..., :C], gb[..., C:]) if strided else (gb[..., :C].contiguous(),
                                                         gb[..., C:].contiguous())
    return x, g, b, extra, bias


@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("C", [12, 64])  # 12: the kernels' scalar path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_folded_bias_is_the_bias_added_to_gamma_and_beta_first(kernel, dtype, C, strided):
    """The fold adds the bias in f32, (1 + b_γ) + γ and β + b_β; adding it to
    γ and β first (in f32) gives the same numbers up to f32 re-association,
    which a cast to bf16 leaves within one bf16 step."""
    wrapper, plain, _, _ = KERNELS[kernel]
    x, g, b, extra, bias = _with_bias(kernel, C, dtype, strided)
    got = plain(x, g, b, *extra, gb_bias=bias)
    with torch.no_grad():
        assert torch.equal(wrapper(x, g, b, *extra, gb_bias=bias), got)
    bf = bias.float()
    want = plain(x.float(), g.float() + bf[:C], b.float() + bf[C:], *extra)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-5 * max(1.0, want.abs().max().item())
    else:
        assert ((got.float() - want).abs() <= want.abs() * 2.0 ** -7 + 1e-6).all()
    assert (got.float() - plain(x, g, b, *extra).float()).abs().max() > 0.1


@pytest.mark.parametrize("C", [12, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_no_bias_is_bit_identical_to_the_unfolded_norm(kernel, dtype, C):
    """``gb_bias=None`` computes what the norm computed before the fold, in
    f32, bit for bit; a zero bias too."""
    wrapper, plain, _, before = KERNELS[kernel]
    x, g, b, extra, bias = _with_bias(kernel, C, dtype, strided=True)
    want = before(x, g, b, *extra)
    with torch.no_grad():
        assert torch.equal(plain(x, g, b, *extra), want)
        assert torch.equal(plain(x, g, b, *extra, gb_bias=None), want)
        assert torch.equal(wrapper(x, g, b, *extra), want)
        assert torch.equal(wrapper(x, g, b, *extra, gb_bias=torch.zeros_like(bias)), want)


@pytest.mark.parametrize("bad", ["shape", "2d", "dtype", "device", "strided"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_wrapper_rejects_a_bias_it_cannot_fold(kernel, bad):
    wrapper = KERNELS[kernel][0]
    x, g, b, extra, bias = _with_bias(kernel, 12, torch.float32, strided=True)
    wrong = dict(shape=bias[:-1], **{"2d": bias.view(2, 12)}, dtype=bias.double(),
                 device=bias.to("meta"), strided=torch.zeros(48)[::2])[bad]
    with torch.no_grad(), pytest.raises(ValueError, match="gb_bias"):
        wrapper(x, g, b, *extra, gb_bias=wrong)


@pytest.mark.parametrize("leaf", ["x", "gamma", "bias"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_folded_bias_raises_under_recording_autograd(kernel, leaf):
    """The fold has no backward: training's norms take no bias."""
    wrapper = KERNELS[kernel][0]
    x, g, b, extra, bias = _with_bias(kernel, 12, torch.float32, strided=False)
    dict(x=x, gamma=g, bias=bias)[leaf].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        wrapper(x, g, b, *extra, gb_bias=bias)
    with torch.no_grad():
        wrapper(x, g, b, *extra, gb_bias=bias)
