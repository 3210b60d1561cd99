"""The port's evaluation metrics (s2p_tpu_torch.gan.{inception, perceptual,
metrics}) against the JAX package's: InceptionV3 pool3 features, the
bilinear resize to 299², VGG16 and LPIPS (calibrated and not), the
LPIPS-style ``PerceptualMetric`` over VGG19 and ``evaluate_pairs(perceptual=)``,
and the torchvision / LPIPS loaders on synthetic state dicts of the right
names and shapes (no weights are downloaded).

Seeded numpy weights (a flax ``params`` tree from ``jax.eval_shape``) go
into both packages. f32 on the CPU. Tolerances: the resize 1e-5 absolute
(values in [−1, 1]); Inception features (75², its smallest input; ~90
layers) 1e-4 relative with 1e-5 absolute; VGG16 features 1e-4; LPIPS and
perceptual distances 1e-4 relative; PSNR and SSIM 1e-5; the loaders
exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.gan.inception import InceptionV3Features as JaxInceptionV3Features
from s2p_tpu.gan.inception import load_torch_inception_v3 as jax_load_torch_inception_v3
from s2p_tpu.gan.inception import resize_bilinear as jax_resize_bilinear
from s2p_tpu.gan.metrics import PerceptualMetric as JaxPerceptualMetric
from s2p_tpu.gan.metrics import evaluate_pairs as jax_evaluate_pairs
from s2p_tpu.gan.perceptual import LPIPSMetric as JaxLPIPSMetric
from s2p_tpu.gan.perceptual import VGG16Features as JaxVGG16Features
from s2p_tpu.gan.perceptual import VGG19Features as JaxVGG19Features
from s2p_tpu.gan.perceptual import load_lpips_linear as jax_load_lpips_linear
from s2p_tpu.gan.perceptual import load_torch_vgg16 as jax_load_torch_vgg16
from s2p_tpu_torch.gan.convert import state_dict_from_jax_params
from s2p_tpu_torch.gan.inception import (
    InceptionV3Features,
    expected_torch_inception_keys,
    inception_fid_extractor,
    load_torch_inception_v3,
    resize_bilinear,
    state_dict_from_jax_inception_params,
)
from s2p_tpu_torch.gan.metrics import PerceptualMetric, evaluate_pairs
from s2p_tpu_torch.gan.perceptual import (
    LPIPSMetric,
    VGG16Features,
    load_lpips_linear,
    load_torch_vgg16,
)
from tests.test_torch_generator import seeded_params

LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def _images(seed, n, size):
    return np.random.RandomState(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def inception_params():
    return seeded_params(JaxInceptionV3Features().init, jnp.zeros((1, 75, 75, 3)), seed=3)


@pytest.fixture(scope="module")
def port_inception(inception_params):
    """The port's network with the JAX weights (built once: drawing its
    seeded weights on the CPU takes seconds)."""
    net = InceptionV3Features(device="cpu")
    net.load_state_dict(state_dict_from_jax_inception_params(inception_params), strict=True)
    return net


def test_inception_features_match_jax(inception_params, port_inception):
    """The whole network at 75²: stem, Mixed_5b..7c (the five block types),
    padding-counting average pools, unpadded max pools, pool3."""
    x = _images(0, 2, 75)
    ref = np.asarray(jax.jit(JaxInceptionV3Features().apply)({"params": inception_params}, x))
    with torch.no_grad():
        got = port_inception(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 2048)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size", [320, 64])
def test_resize_bilinear_matches_jax(size):
    """Half-pixel centres both ways; antialiased when it downsamples."""
    x = _images(1, 2, size)
    got = resize_bilinear(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _synthetic_torchvision_inception(template, rs, values=True):
    """A torchvision-named random ``inception_v3`` state dict with the
    shapes of the flax template (only its keys unless ``values``)."""
    sd = {}

    def rec(node, path):
        if "bn_scale" in node:
            if not values:
                sd.update({f"{path}.{leaf}": None for leaf in (
                    "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")})
                return
            h, w, c_in, c_out = node["conv"]["kernel"].shape
            sd[f"{path}.conv.weight"] = 0.05 * rs.randn(c_out, c_in, h, w).astype(np.float32)
            sd[f"{path}.bn.weight"] = rs.rand(c_out).astype(np.float32) + 0.5
            sd[f"{path}.bn.bias"] = 0.1 * rs.randn(c_out).astype(np.float32)
            sd[f"{path}.bn.running_mean"] = 0.1 * rs.randn(c_out).astype(np.float32)
            sd[f"{path}.bn.running_var"] = rs.rand(c_out).astype(np.float32) + 0.5
            return
        for k, v in node.items():
            rec(v, f"{path}.{k}" if path else k)

    rec(template, "")
    return sd


def test_inception_loader_folds_batchnorm_as_jax(inception_params):
    """BN folded with ε 1e-3 into the same f32 affine as the JAX loader (on
    the stem and one block of each type); the classifier, the auxiliary
    head and num_batches_tracked ignored; the expected key list is the
    torchvision dict's, and a dict of every module loads strictly."""
    names = ("Conv2d_1a_3x3", "Conv2d_4a_3x3", "Mixed_5b", "Mixed_6a", "Mixed_6b", "Mixed_7a",
             "Mixed_7b")
    shapes = jax.tree_util.tree_map(lambda a: np.broadcast_to(np.float32(0), a.shape),
                                    inception_params)
    assert sorted(expected_torch_inception_keys()) == sorted(
        _synthetic_torchvision_inception(shapes, np.random.RandomState(4), values=False))
    sd = _synthetic_torchvision_inception({k: shapes[k] for k in names},
                                          np.random.RandomState(4))
    sd.update({"fc.weight": np.zeros((10, 2048), np.float32),
               "AuxLogits.conv0.conv.weight": np.zeros((128, 768, 1, 1), np.float32),
               "AuxLogits.conv0.bn.running_var": np.ones(128, np.float32),
               "Conv2d_1a_3x3.bn.num_batches_tracked": np.int64(3)})
    got = load_torch_inception_v3(sd)
    ref = state_dict_from_jax_params(jax.device_get(jax_load_torch_inception_v3(sd))["params"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    full = state_dict_from_jax_inception_params(inception_params)
    full.update(got)
    with torch.device("meta"):  # names and shapes only
        InceptionV3Features(device="meta").load_state_dict(full, strict=True, assign=True)
    m = "Mixed_6b.branch7x7_2"
    scale = sd[f"{m}.bn.weight"] / np.sqrt(sd[f"{m}.bn.running_var"] + 1e-3)
    np.testing.assert_array_equal(got[f"{m}.bn_scale"].numpy(), scale)


def test_fid_extractor_resizes_then_pools(inception_params, port_inception):
    sd = state_dict_from_jax_inception_params(inception_params)
    extract = inception_fid_extractor(sd, seed=1, device="cpu")
    x = torch.from_numpy(_images(2, 1, 32))
    feats = extract(x)
    with torch.no_grad():
        assert torch.equal(feats, port_inception(resize_bilinear(x)))
    assert feats.shape == (1, 2048) and torch.isfinite(feats).all()


@pytest.fixture(scope="module")
def vgg16_params():
    return seeded_params(JaxVGG16Features().init, jnp.zeros((1, 32, 32, 3)), seed=5)


def test_vgg16_features_and_loader_match_jax(vgg16_params):
    x = _images(6, 2, 32)
    ref = jax.jit(JaxVGG16Features().apply)({"params": vgg16_params}, x)
    vgg = VGG16Features(device="cpu")
    vgg.load_state_dict(state_dict_from_jax_params(vgg16_params), strict=True)
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert [tuple(f.shape) for f in got] == [r.shape for r in ref] == [
        (2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512), (2, 2, 2, 512)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
    rs = np.random.RandomState(7)
    tv = {f"features.{k.split('.')[0][4:]}.{k.split('.')[1]}": rs.randn(*v.shape).astype(np.float32)
          for k, v in vgg.state_dict().items()}
    tv["classifier.0.weight"] = np.zeros((4, 4), np.float32)
    loaded = load_torch_vgg16(tv)
    ref_sd = state_dict_from_jax_params(jax.device_get(jax_load_torch_vgg16(tv))["params"])
    assert sorted(loaded) == sorted(ref_sd)
    for k in ref_sd:
        assert torch.equal(loaded[k], ref_sd[k]), k


@pytest.mark.parametrize("calibrated", [True, False])
def test_lpips_matches_jax(vgg16_params, calibrated):
    rs = np.random.RandomState(8)
    lin_sd = {f"lin{k}.model.1.weight": rs.rand(1, c, 1, 1).astype(np.float32)
              for k, c in enumerate(LPIPS_CHANNELS)}
    lin = load_lpips_linear(lin_sd) if calibrated else None
    if calibrated:
        for g, r in zip(lin, jax_load_lpips_linear(lin_sd)):
            np.testing.assert_array_equal(g, r)
    a, b = _images(9, 3, 32), _images(10, 3, 32)
    ref = JaxLPIPSMetric({"params": vgg16_params}, lin_weights=lin)(a, b)
    m = LPIPSMetric(state_dict_from_jax_params(vgg16_params), lin_weights=lin, device="cpu")
    assert m.calibrated == calibrated
    got = m(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (3,) and (got > 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)
    np.testing.assert_allclose(m(a, a).numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(m(b, a).numpy(), got.numpy(), rtol=1e-5)


def test_perceptual_metric_and_evaluate_pairs_match_jax():
    params = seeded_params(JaxVGG19Features().init, jnp.zeros((1, 32, 32, 3)), seed=11)
    fake, real = _images(12, 3, 32), _images(13, 3, 32)
    jm = JaxPerceptualMetric({"params": params})
    m = PerceptualMetric(state_dict_from_jax_params(params), device="cpu")
    np.testing.assert_allclose(m(fake, real).numpy(), np.asarray(jm(fake, real)), rtol=1e-4)
    ref = jax_evaluate_pairs(fake, real, perceptual=jm)
    got = evaluate_pairs(torch.from_numpy(fake), real, perceptual=m)
    assert sorted(got) == sorted(ref) == ["lpips_vgg", "psnr", "ssim"]
    np.testing.assert_allclose(got["lpips_vgg"], ref["lpips_vgg"], rtol=1e-4)
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert sorted(evaluate_pairs(fake, real)) == ["psnr", "ssim"]
