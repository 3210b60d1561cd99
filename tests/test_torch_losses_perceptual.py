"""The port's GAN losses and VGG19 perceptual loss against the JAX package
on the same seeded inputs and weights: losses at 1e-6, VGG features and
the perceptual loss at 1e-4 (f32, CPU, 16px)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.gan import losses as jl
from s2p_tpu.gan.perceptual import PerceptualLoss as JaxPerceptualLoss
from s2p_tpu.gan.perceptual import VGG19Features as JaxVGG19Features
from s2p_tpu.gan.perceptual import load_torch_vgg19 as jax_load_torch_vgg19
from s2p_tpu_torch.gan import losses as tl
from s2p_tpu_torch.gan.convert import state_dict_from_jax_params
from s2p_tpu_torch.gan.perceptual import (
    SLICE_WEIGHTS,
    PerceptualLoss,
    VGG19Features,
    load_torch_vgg19,
)

from test_torch_generator import seeded_params


def _feats(rs, shapes):
    return [[rs.randn(*s).astype(np.float32) for s in scale] for scale in shapes]


FEAT_SHAPES = [[(2, 9, 9, 8), (2, 5, 5, 16), (2, 6, 6, 1)],
               [(2, 5, 5, 8), (2, 3, 3, 16), (2, 4, 4, 1)]]


def _t(tree):
    return [[torch.from_numpy(a) for a in fs] for fs in tree]


def test_hinge_and_feature_matching_losses_match_jax():
    rs = np.random.RandomState(0)
    real, fake = _feats(rs, FEAT_SHAPES), _feats(rs, FEAT_SHAPES)
    pairs = [
        (jl.hinge_d_loss(jl.logits_of(real), jl.logits_of(fake)),
         tl.hinge_d_loss(tl.logits_of(_t(real)), tl.logits_of(_t(fake)))),
        (jl.hinge_g_loss(jl.logits_of(fake)), tl.hinge_g_loss(tl.logits_of(_t(fake)))),
        (jl.feature_matching_loss(real, fake), tl.feature_matching_loss(_t(real), _t(fake))),
        (jl.l1_loss(real[0][0], fake[0][0]),
         tl.l1_loss(torch.from_numpy(real[0][0]), torch.from_numpy(fake[0][0]))),
        (jl.r1_penalty(real[0][1]), tl.r1_penalty(torch.from_numpy(real[0][1]))),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6, atol=1e-6)


def test_feature_matching_detaches_real():
    rs = np.random.RandomState(1)
    real = [[torch.from_numpy(a).requires_grad_() for a in fs]
            for fs in _feats(rs, FEAT_SHAPES)]
    fake = [[torch.from_numpy(a).requires_grad_() for a in fs]
            for fs in _feats(rs, FEAT_SHAPES)]
    tl.feature_matching_loss(real, fake).backward()
    assert all(r.grad is None for fs in real for r in fs)
    assert all(f.grad is not None for fs in fake for f in fs[:-1]) and fake[0][-1].grad is None


def test_loss_config_defaults_match_jax():
    import dataclasses

    assert dataclasses.asdict(tl.GANLossConfig()) == dataclasses.asdict(jl.GANLossConfig())


def vgg_pair(size=16, seed=0):
    params = seeded_params(JaxVGG19Features().init, jnp.zeros((1, size, size, 3)), seed=seed)
    vgg = VGG19Features(device="cpu")
    vgg.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return params, vgg


def test_vgg19_features_and_perceptual_loss_match_jax():
    params, vgg = vgg_pair()
    rs = np.random.RandomState(2)
    x, y = ((rs.rand(2, 16, 16, 3) * 2 - 1).astype(np.float32) for _ in range(2))
    ref = jax.jit(JaxVGG19Features().apply)({"params": params}, x)
    with torch.no_grad():
        out = vgg(torch.from_numpy(x))
    assert len(out) == len(ref) == len(SLICE_WEIGHTS)
    for f, r in zip(out, ref):
        assert tuple(f.shape) == r.shape
        np.testing.assert_allclose(f.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)

    jloss = JaxPerceptualLoss({"params": params})
    ref_loss, ref_grad = jax.jit(jax.value_and_grad(jloss))(x, y)
    loss_fn = PerceptualLoss(vgg.state_dict(), device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    loss = loss_fn(xt, yt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-6)
    assert yt.grad is None and not any(p.requires_grad for p in loss_fn.parameters())


def test_load_torch_vgg19_matches_jax():
    """The same fake torchvision ``vgg19`` state dict through both loaders."""
    rs = np.random.RandomState(3)
    vgg = VGG19Features(device="cpu")
    fake_tv = {}
    for k, v in vgg.state_dict().items():
        li = k.split(".")[0][len("conv"):]
        fake_tv[f"features.{li}.{k.split('.')[1]}"] = rs.randn(*v.shape).astype(np.float32)
    fake_tv["classifier.0.weight"] = np.zeros((4, 4), np.float32)  # ignored
    sd = load_torch_vgg19(fake_tv)
    ref = state_dict_from_jax_params(jax_load_torch_vgg19(fake_tv)["params"])
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    vgg.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_vgg_seeded_init_is_deterministic_and_frozen(seed):
    a, b = VGG19Features(seed=seed, device="cpu"), VGG19Features(seed=seed, device="cpu")
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())
    assert not any(p.requires_grad for p in a.parameters())
