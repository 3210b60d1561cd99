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
