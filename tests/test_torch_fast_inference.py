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


@pytest.mark.parametrize("size", [64, 25, 100])
def test_fast_apply_matches_jax(size):
    """100 is the bridge's ragged chain 100 → 50 → 25 → 13 → 7."""
    jgen, params, gen = make_pair(size)
    s, img = inputs(size)
    jfast = jax.jit(lambda p, s, i: jax_fast_apply(
        jgen, {"params": jax_fuse_fast_params(p)}, s, i))
    ref = np.asarray(jfast(params, s, img))
    fused = fuse_fast_params(gen)
    widths = [sum(b["shared_cat"]["widths"]) for b in fused["blocks"]]
    assert widths == [b["shared_cat"]["weight"].shape[0] for b in fused["blocks"]]
    assert fused["cmap_terms_all"].shape[-1] == sum(widths)
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
    module = generate_rollout(gen, img_t, states_t)
    np.testing.assert_allclose(module.numpy(), out.numpy(), rtol=5e-3, atol=5e-3)


def test_fast_path_rejects_sat_modes():
    _, _, gen = make_pair(64, "sat_state")
    with pytest.raises(ValueError, match="MAT layout"):
        fuse_fast_params(gen)


@pytest.mark.parametrize("gb_int8", [False, True])
def test_gb_bias_is_folded_into_the_norm_once(monkeypatch, gb_int8):
    """The float path runs each γ‖β conv without its bias and hands the bias
    to the MAT norm; the int8 path adds it in its own epilogue and hands the
    norm none, so no path adds it twice. Both stay where the existing tests
    hold them: the float path at the module path, the int8 path at the
    float path's PSNR bar."""
    import s2p_tpu_torch.gan.fast_inference as fi

    _, _, gen = make_pair(64)
    s, img = (torch.from_numpy(a) for a in inputs(64))
    fused = fuse_fast_params(gen, gb_int8=gb_int8)
    norms = [blk[n] for blk in fused["blocks"] for n in blk["norms"]]
    gb_weights = {id(p["mlp_gb"]["weight"]) for p in norms}
    conv_biases, norm_biases = [], []
    real_conv, real_norm = F.conv2d, fi.mat_norm_nchw

    def conv_spy(inp, weight, bias=None, *args, **kw):
        if id(weight) in gb_weights:
            conv_biases.append(bias)
        return real_conv(inp, weight, bias, *args, **kw)

    def norm_spy(x, gamma, beta, gb_bias=None):
        norm_biases.append(gb_bias)
        return real_norm(x, gamma, beta, gb_bias)

    monkeypatch.setattr(fi.F, "conv2d", conv_spy)
    monkeypatch.setattr(fi, "mat_norm_nchw", norm_spy)
    out = fast_apply(gen, fused, s, img, gb_int8=gb_int8)
    monkeypatch.undo()
    assert len(norms) == 13
    if gb_int8:
        assert conv_biases == [] and norm_biases == [None] * 13
        float_out = fast_apply(gen, fused, s, img).numpy()
        mse = float(np.mean((out.numpy() - float_out) ** 2))
        assert 10 * np.log10(4.0 / max(mse, 1e-12)) > 40.0
    else:
        assert conv_biases == [None] * 13
        assert [id(b) for b in norm_biases] == [id(p["mlp_gb"]["bias"]) for p in norms]
        with torch.no_grad():
            module = gen(s, img).numpy()
        np.testing.assert_allclose(out.numpy(), module, rtol=2e-4, atol=2e-4)
