"""The port's fidelity metrics against the JAX package on the same seeded
images (f32, CPU): PSNR and SSIM at 1e-5, the Fréchet distance and FID at
1e-6 relative (the same host scipy code on float64 features)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2p_tpu.gan import metrics as jm
from s2p_tpu.gan.perceptual import VGG19Features as JaxVGG19Features
from s2p_tpu_torch.gan import metrics as tm
from s2p_tpu_torch.gan.convert import state_dict_from_jax_params

from test_torch_generator import seeded_params


def _pair(shape, seed=0):
    rs = np.random.RandomState(seed)
    a = (rs.rand(*shape) * 2 - 1).astype(np.float32)
    b = np.clip(a + 0.2 * rs.randn(*shape), -1, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(3, 16, 16, 3), (2, 2, 25, 25, 3)])
def test_psnr_ssim_match_jax(shape):
    a, b = _pair(shape, seed=len(shape))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tm.psnr(ta, tb).numpy(), np.asarray(jm.psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(tm.ssim(ta, tb).numpy(), np.asarray(jm.ssim(a, b)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.psnr(ta, ta).numpy(), 10 * np.log10(4 / 1e-12), rtol=1e-6)
    np.testing.assert_allclose(tm.ssim(ta, ta).numpy(), 1.0, atol=1e-5)


def test_evaluate_pairs_matches_jax():
    a, b = _pair((4, 16, 16, 3), seed=5)
    ours, ref = tm.evaluate_pairs(a, b), jm.evaluate_pairs(a, b)
    assert sorted(ours) == sorted(ref) == ["psnr", "ssim"]
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-6)


def test_frechet_distance_matches_jax():
    rs = np.random.RandomState(7)
    f1, f2 = rs.randn(40, 6), 0.5 + 1.3 * rs.randn(40, 6)
    ours = tm.frechet_distance(*tm.feature_stats(f1), *tm.feature_stats(f2))
    ref = jm.frechet_distance(*jm.feature_stats(f1), *jm.feature_stats(f2))
    assert ours == pytest.approx(ref, rel=1e-9) and ours > 0
    assert tm.frechet_distance(*tm.feature_stats(f1), *tm.feature_stats(f1)) == pytest.approx(
        0.0, abs=1e-6)


def test_vgg_fid_matches_jax_with_the_same_weights():
    params = seeded_params(JaxVGG19Features().init, jnp.zeros((1, 16, 16, 3)), seed=4)
    extractor = tm.vgg_fid_extractor(state_dict_from_jax_params(params), device="cpu")
    jext = jm.vgg_fid_extractor({"params": params}, image_shape=(16, 16, 3))
    reals = [_pair((8, 16, 16, 3), seed=s)[0] for s in (1, 2)]
    fakes = [_pair((8, 16, 16, 3), seed=s)[1] for s in (1, 2)]
    np.testing.assert_allclose(extractor(torch.from_numpy(reals[0])).numpy(),
                               np.asarray(jext(reals[0])), rtol=1e-4, atol=1e-5)
    ours = tm.compute_fid(extractor, reals, fakes)
    ref = jm.compute_fid(jext, reals, fakes)
    assert ours == pytest.approx(ref, rel=1e-3)
