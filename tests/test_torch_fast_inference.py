"""The port's fast path (s2p_tpu_torch.gan.fast_inference) against the JAX
reference and against the port's module path. Tolerances from
test_fast_inference.py: the constant-map shortcut 1e-5, fast apply 1e-4,
rollouts (autoregressive error compounds) 5e-3."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from s2p_tpu.gan.fast_inference import conv_const_map as jax_conv_const_map
from s2p_tpu.gan.fast_inference import fast_apply as jax_fast_apply
from s2p_tpu.gan.fast_inference import fuse_fast_params as jax_fuse_fast_params
from s2p_tpu.gan.fast_inference import generate_rollout_fast as jax_generate_rollout_fast
from s2p_tpu_torch.gan import fast_apply, fuse_fast_params, generate_rollout, generate_rollout_fast
from s2p_tpu_torch.gan.fast_inference import _const_map_from_t, conv_const_map

from test_torch_generator import STATE_DIM, inputs, make_pair


@pytest.mark.parametrize("H,W", [(7, 5), (1, 1), (1, 4), (3, 1)])
def test_conv_const_map_matches_real_conv_and_jax(H, W):
    """Including 1-pixel rows/columns, where both borders and all four
    corners land on the same pixels."""
    rs = np.random.RandomState(1)
    B, S, Fo = 2, 6, 4
    e = rs.randn(B, S).astype(np.float32)
    k_hwio = rs.randn(3, 3, S, Fo).astype(np.float32)
    k = torch.from_numpy(k_hwio).permute(3, 2, 0, 1)  # OIHW
    et = torch.from_numpy(e)
    const_map = et[:, :, None, None].expand(B, S, H, W)
    ref = F.conv2d(const_map, k, padding=1)
    out = conv_const_map(et, k, H, W)
    assert out.shape == (B, Fo, H, W)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    jref = np.asarray(jax_conv_const_map(jnp.asarray(e), jnp.asarray(k_hwio), H, W))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), jref, rtol=1e-5, atol=1e-5)


def test_const_map_border_masks_exact_in_bf16_at_large_res():
    """Masks compare INTEGER indices: in bf16 the indices near 511 round,
    and a mask built in that type would hit several rows."""
    B, Fo, H, W = 1, 1, 512, 512
    t = torch.zeros(B, 9, Fo)
    t[:, 1:5, 0] = torch.tensor([1.0, 2, 3, 4])      # top/bottom/left/right
    t[:, 5:9, 0] = torch.tensor([10.0, 20, 30, 40])  # the 4 corners
    out = _const_map_from_t(t.to(torch.bfloat16), H, W).float()[0, 0]
    assert (out[1:-1, 1:-1] == 0).all()
    assert (out[0, 1:-1] == -1).all() and (out[-1, 1:-1] == -2).all()
    assert (out[1:-1, 0] == -3).all() and (out[1:-1, -1] == -4).all()
    assert out[0, 0] == -1 - 3 + 10 and out[-1, -1] == -2 - 4 + 40


@pytest.mark.parametrize("block_level", [True, False])
@pytest.mark.parametrize("size", [64, 25])
def test_fast_apply_matches_jax(size, block_level):
    jgen, params, gen = make_pair(size)
    s, img = inputs(size)
    jfast = jax.jit(lambda p, s, i: jax_fast_apply(
        jgen, {"params": jax_fuse_fast_params(p, block_level=block_level)}, s, i))
    ref = np.asarray(jfast(params, s, img))
    fused = fuse_fast_params(gen, block_level=block_level)
    assert ("cmap_terms_all" in fused) == block_level
    assert all(("shared_cat" in b) == block_level for b in fused["blocks"])
    out = fast_apply(gen, fused, torch.from_numpy(s), torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        module = gen(torch.from_numpy(s), torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, module, rtol=2e-4, atol=2e-4)


def test_fast_rollout_matches_jax_and_module_rollout():
    jgen, params, gen = make_pair(64)
    _, img = inputs(64)
    states = np.random.RandomState(2).randn(3, 2, STATE_DIM).astype(np.float32)
    ref = np.asarray(jax_generate_rollout_fast(jgen, {"params": params}, img, states))
    img_t, states_t = torch.from_numpy(img), torch.from_numpy(states)
    out = generate_rollout_fast(gen, img_t, states_t)
    assert out.shape == ref.shape == (3, 2, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-3, atol=5e-3)
    per_norm = generate_rollout_fast(gen, img_t, states_t, block_fusion=False)
    np.testing.assert_allclose(per_norm.numpy(), out.numpy(), rtol=1e-4, atol=1e-4)
    module = generate_rollout(gen, img_t, states_t)
    np.testing.assert_allclose(module.numpy(), out.numpy(), rtol=5e-3, atol=5e-3)


def test_fast_path_rejects_sat_modes():
    _, _, gen = make_pair(64, "sat_state")
    with pytest.raises(ValueError, match="MAT layout"):
        fuse_fast_params(gen)
