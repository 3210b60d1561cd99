"""The port's opt-in int8 γ‖β modulation (``gb_int8`` in
s2p_tpu_torch.gan.fast_inference and ``simple_test --gb_int8``) against the
JAX package's, on the CPU.

Quantized weights are equal and their scales agree to 1e-7; the int8 conv
on identical inputs agrees to 1e-6 (int32 sums are exact, only the f32
dequantization rounds); a whole step agrees to 1e-3, since a last-bit
difference in the hidden map upstream can flip one 8-bit rounding. Against
the float path the int8 frames hold the JAX test's PSNR bar. One deliberate
difference: the port raises where ``gb_int8`` meets parameters without the
int8 operands; JAX runs the float path."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.gan.fast_inference import _conv_gb_int8 as jax_conv_gb_int8
from s2p_tpu.gan.fast_inference import fast_apply as jax_fast_apply
from s2p_tpu.gan.fast_inference import fuse_fast_params as jax_fuse_fast_params
from s2p_tpu.gan.fast_inference import generate_rollout_fast as jax_generate_rollout_fast
from s2p_tpu_torch.cli.simple_test import main as gen_main
from s2p_tpu_torch.data.hdf5 import make_synthetic_rl_dataset, save_dataset
from s2p_tpu_torch.gan import fast_apply, fuse_fast_params, generate_rollout_fast
from s2p_tpu_torch.gan.fast_inference import _conv_gb_int8, _quantize_gb_kernel

from test_torch_generator import STATE_DIM, inputs, make_pair


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """dB over the [-1, 1] range (peak-to-peak 2), as the JAX test takes it."""
    return 10 * np.log10(4.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def test_quantized_weights_equal_jax():
    _, params, gen = make_pair(64)
    ours = fuse_fast_params(gen, gb_int8=True)
    ref = jax_fuse_fast_params(jax.tree_util.tree_map(jnp.asarray, params), gb_int8=True)
    n = 0
    for i, blk in enumerate(ours["blocks"]):
        for name in blk["norms"]:
            q, jq = blk[name]["mlp_gb_q"], ref[f"block_{i}"][name]["mlp_gb_q"]
            jk = np.asarray(jq["kernel_i8"])
            assert q["kernel_i8"].dtype == torch.int8 and q["kernel_i8"].is_contiguous()
            np.testing.assert_array_equal(q["kernel_i8"].numpy(), jk.reshape(-1, jk.shape[-1]))
            np.testing.assert_allclose(q["scale_w"].numpy(), np.asarray(jq["scale_w"]),
                                       rtol=1e-7, atol=0)
            n += 1
    assert n == 13
    assert "mlp_gb_q" not in fuse_fast_params(gen)["blocks"][0]["norm_0"]


@pytest.mark.parametrize("B,H,W", [(2, 5, 7), (1, 4, 4), (3, 8, 8)])
def test_conv_gb_int8_matches_jax(B, H, W):
    """Row counts 70, 16 (padded to 17 for the int32 product) and 192."""
    rs = np.random.RandomState(B * H)
    C, N = 16, 24
    h = np.maximum(rs.randn(B, H, W, C), 0).astype(np.float32)
    k = (rs.randn(3, 3, C, N) / np.sqrt(9 * C)).astype(np.float32)
    bias = (0.1 * rs.randn(N)).astype(np.float32)
    weight = torch.from_numpy(k).permute(3, 2, 0, 1)  # HWIO → OIHW
    q = _quantize_gb_kernel(weight)
    jq = {"kernel_i8": jnp.asarray(q["kernel_i8"].numpy().reshape(3, 3, C, N)),
          "scale_w": jnp.asarray(q["scale_w"].numpy())}
    ref = np.asarray(jax_conv_gb_int8(jnp.asarray(h), jq, jnp.asarray(bias)))
    hn = torch.from_numpy(h).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    out = _conv_gb_int8(hn, q, torch.from_numpy(bias))
    assert out.shape == (B, N, H, W) and out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-6, atol=1e-6)
    # dequantized, the int8 product is close to the float conv
    f32 = torch.nn.functional.conv2d(hn, weight, torch.from_numpy(bias), padding=1)
    assert (out - f32).abs().max() < 0.05 * f32.abs().max()


@pytest.mark.parametrize("size,batch", [(64, 2), (64, 1), (25, 2)])
def test_fast_apply_gb_int8_matches_jax(size, batch):
    """Batch 1 at 64px: the 4×4 seed block gives 16 rows (padded)."""
    jgen, params, gen = make_pair(size)
    s, img = inputs(size, batch=batch)
    jfast = jax.jit(lambda p, s, i: jax_fast_apply(
        jgen, {"params": jax_fuse_fast_params(p, gb_int8=True)}, s, i, gb_int8=True))
    ref = np.asarray(jfast(params, s, img))
    fused = fuse_fast_params(gen, gb_int8=True)
    out = fast_apply(gen, fused, torch.from_numpy(s), torch.from_numpy(img), gb_int8=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-3)
    assert psnr(out.numpy(), fast_apply(gen, fused, torch.from_numpy(s),
                                        torch.from_numpy(img)).numpy()) > 40.0


def test_float_path_unchanged_by_quantized_operands():
    _, _, gen = make_pair(64)
    s, img = (torch.from_numpy(a) for a in inputs(64))
    plain = fast_apply(gen, fuse_fast_params(gen), s, img)
    with_q = fast_apply(gen, fuse_fast_params(gen, gb_int8=True), s, img)
    assert torch.equal(plain, with_q)


def test_gb_int8_raises_on_unquantized_params():
    _, _, gen = make_pair(64)
    s, img = (torch.from_numpy(a) for a in inputs(64))
    for block_level in (True, False):
        with pytest.raises(ValueError, match="gb_int8=True"):
            fast_apply(gen, fuse_fast_params(gen, block_level=block_level), s, img, gb_int8=True)


def test_gb_int8_rollout_matches_jax_and_holds_psnr():
    jgen, params, gen = make_pair(64)
    _, img = inputs(64)
    states = np.random.RandomState(2).randn(2, 2, STATE_DIM).astype(np.float32)
    ref = np.asarray(jax_generate_rollout_fast(jgen, {"params": params}, img, states,
                                               gb_int8=True))
    img_t, states_t = torch.from_numpy(img), torch.from_numpy(states)
    out = generate_rollout_fast(gen, img_t, states_t, gb_int8=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=5e-3, atol=5e-3)
    assert psnr(out, generate_rollout_fast(gen, img_t, states_t).numpy()) > 38.0
    per_norm = generate_rollout_fast(gen, img_t, states_t, block_fusion=False, gb_int8=True)
    np.testing.assert_allclose(per_norm.numpy(), out, rtol=1e-3, atol=1e-3)


def test_simple_test_gb_int8_at_batch_1(tmp_path):
    """``simple_test --fast_inference --gb_int8`` on the CPU: batch 1 at
    64px, whose 4×4 seed block gives the int32 product 16 rows."""
    ds = make_synthetic_rl_dataset(n_episodes=1, episode_len=6, obs_dim=STATE_DIM, act_dim=6,
                                   img_hw=64)
    data = str(tmp_path / "cheetah.hdf5")
    save_dataset(data, ds)
    common = ["--dataroot", data, "--seq_len", "2", "--ngf", "8", "--init_random",
              "--gpu_ids=-1", "--fast_inference"]
    import imageio.v2 as imageio

    strips = []
    for name, extra in (("int8", ["--gb_int8"]), ("float", [])):
        out_dir = gen_main(common + extra + ["--results_dir", str(tmp_path / name)])
        assert sorted(os.listdir(out_dir)) == ["gen_00001.png", "gen_00002.png",
                                               "real_00000.png", "rollout_00000.png"]
        strips.append(imageio.imread(os.path.join(out_dir, "rollout_00000.png")))
    assert strips[0].shape == strips[1].shape == (128, 128, 3)
    assert np.abs(strips[0].astype(int) - strips[1].astype(int)).mean() < 2
