"""The port's CURL/RAD pixel path against the JAX package's, on the CPU.

- Augmentations (``nn.augmentations``): each entry of ``AUGMENTATIONS`` on a
  seeded uint8 NHWC batch, with JAX's draws computed from its key and
  handed to the port. Crop, translate, flip, rotation, cutout and no-aug
  are bit-equal; grayscale, the random convolution and the colour jitter
  are bit-equal where the arithmetic allows, else within one uint8 step on
  a share of the pixels asserted below.
- Encoders (``rl.encoders``): the pixel encoder, the encoder Q/V, the twin
  critic over one shared encoder, the policy with an encoder and CURL, with
  weights carried over by the converters; outputs and gradients within
  1e-5 of the largest. Mutations that must fail: a flatten left in NCHW
  order, a policy that does not detach by default; under ``detach`` the
  convs' gradients are exactly 0 and ``fc``'s are not.
- Misc nets (``nn.misc_nets``): spatial softmax, the keypoint encoder and
  MLP, the image/state switches and the pretrained-feature head, 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s2p_tpu.nn.augmentations as jaug
from s2p_tpu.nn.misc_nets import FeatPointMlp as JaxFeatPointMlp
from s2p_tpu.nn.misc_nets import ImageStatePolicy as JaxImageStatePolicy
from s2p_tpu.nn.misc_nets import ImageStateQ as JaxImageStateQ
from s2p_tpu.nn.misc_nets import PretrainedCNN as JaxPretrainedCNN
from s2p_tpu.nn.misc_nets import spatial_softmax as jax_spatial_softmax
from s2p_tpu.nn.mlp import Mlp as JaxMlp
from s2p_tpu.rl import encoders as jenc
from s2p_tpu_torch.data.loaders import conv_stack_output_shape
from s2p_tpu_torch.nn import augmentations as aug
from s2p_tpu_torch.nn.misc_nets import (FeatPointMlp, ImageStatePolicy, ImageStateQ, PretrainedCNN,
                                        jax_misc_params_from_state_dict, spatial_softmax,
                                        state_dict_from_jax_misc_params)
from s2p_tpu_torch.nn.mlp import Mlp
from s2p_tpu_torch.rl import encoders as enc
from tests.test_torch_generator import seeded_params

B, SIZE, C = 6, 32, 9  # a frame stack of 3 RGB frames
FEAT, LAYERS, FILTERS, HIDDEN, ACT = 16, 2, 8, (16,), 3
REL = 1e-5


def images(c=C, size=SIZE, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, size, size, c), dtype=np.uint8)


# -- augmentations ----------------------------------------------------------------


def jax_draws(name, key, x, **kw):
    """The draws the JAX augmentation ``name`` takes from ``key``, as torch
    tensors, keyed by the port's keyword names."""
    b, h, w, c = x.shape
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if name in ("crop", "translate"):
        k1, k2 = jax.random.split(key)
        hi_h, hi_w = ((h - kw["out"] + 1, w - kw["out"] + 1) if name == "crop"
                      else (kw["size"] - h + 1, kw["size"] - w + 1))
        return dict(h=t(jax.random.randint(k1, (b,), 0, hi_h)),
                    w=t(jax.random.randint(k2, (b,), 0, hi_w)))
    if name in ("grayscale", "flip"):
        return dict(mask=t(jax.random.bernoulli(key, kw["p"], (b,))))
    if name == "rotation":
        k1, k2 = jax.random.split(key)
        return dict(mask=t(jax.random.bernoulli(k1, 0.3, (b,))),
                    rot=t(jax.random.randint(k2, (b,), 1, 4)))
    if name == "cutout":
        k1, k2, k3, _ = jax.random.split(key, 4)
        lo, hi = kw["min_cut"], kw["max_cut"]
        return dict(sizes=t(jax.random.randint(k1, (b,), lo, hi)),
                    h0=t(jax.random.randint(k2, (b,), 0, h - hi)),
                    w0=t(jax.random.randint(k3, (b,), 0, w - hi)))
    if name == "cutout_color":
        k1, k2 = jax.random.split(key)
        return dict(color=t(jax.random.randint(k1, (b, c), 0, 255)),
                    **jax_draws("cutout", k2, x, **kw))
    if name == "convolution":
        return dict(weights=t(jax.random.uniform(key, (b, 3, 3, c, c), minval=-1.0, maxval=1.0)))
    if name == "color_jitter":
        k1, k2 = jax.random.split(key)
        return dict(b=t(jax.random.uniform(k1, (b, 1, 1, 1), minval=0.6, maxval=1.4)),
                    c=t(jax.random.uniform(k2, (b, 1, 1, 1), minval=0.6, maxval=1.4)))
    return {}


# (name, positional arguments after the images, keyword arguments of the
# draws, channels); grayscale needs RGB
CASES = {
    "crop": ((20,), dict(out=20), C),
    "translate": ((40,), dict(size=40), C),
    "grayscale": ((0.5,), dict(p=0.5), 3),
    "cutout": ((4, 12), dict(min_cut=4, max_cut=12), C),
    "cutout_color": ((4, 12), dict(min_cut=4, max_cut=12), C),
    "flip": ((0.5,), dict(p=0.5), C),
    "rotation": ((), {}, C),
    "convolution": ((), {}, C),
    "color_jitter": ((), {}, C),
    "no_aug": ((), {}, C),
}
# at most one uint8 step apart, on at most this share of the values: the
# three augmentations that sum in f32. Grayscale's three terms and the
# jitter's per-image mean come out bit-equal here; the convolution's 81-term
# sums, ordered differently by XLA's and PyTorch's CPU convolutions, put 1
# of these 55,296 values one step apart (1.8e-5)
ONE_STEP_SHARE = {"grayscale": 0.0, "convolution": 1e-4, "color_jitter": 0.0}


@pytest.mark.parametrize("name", sorted(CASES))
def test_augmentation_matches_jax_on_its_draws(name):
    args, kw, c = CASES[name]
    x = images(c)
    key = jax.random.PRNGKey(sorted(CASES).index(name))
    ref = np.asarray(jaug.AUGMENTATIONS[name](key, jnp.asarray(x), *args))
    draws = jax_draws(name, key, x, **kw)
    got = aug.AUGMENTATIONS[name](None, torch.from_numpy(x), *args, **draws).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    if name not in ONE_STEP_SHARE:
        np.testing.assert_array_equal(got, ref)
    else:
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() <= ONE_STEP_SHARE[name], (diff > 0).mean()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_rot90_turns_as_jax_does(k):
    """``torch.rot90(dims=(1, 2))`` turns NHWC images the way
    ``jnp.rot90(axes=(1, 2))`` does, for every count the rotation draws."""
    x = np.random.RandomState(k).randint(0, 256, (2, 5, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(torch.rot90(torch.from_numpy(x), k, dims=(1, 2)).numpy(),
                                  np.asarray(jnp.rot90(jnp.asarray(x), k, axes=(1, 2))))
    rot = torch.full((2,), k)
    got = aug.random_rotation(None, torch.from_numpy(x), mask=torch.tensor([True, False]),
                              rot=rot).numpy()
    np.testing.assert_array_equal(got[0], np.rot90(x[0], k, axes=(0, 1)))
    np.testing.assert_array_equal(got[1], x[1])


def test_flip_reverses_the_width_axis():
    x = images()
    got = aug.random_flip(None, torch.from_numpy(x), mask=torch.ones(B, dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), x[:, :, ::-1])


def test_grayscale_is_a_three_term_f32_dot_cast_back():
    x = images(3)
    f = x.astype(np.float32)
    w = np.asarray([0.2989, 0.587, 0.114], np.float32)
    g = (f[..., 0] * w[0] + f[..., 1] * w[1] + f[..., 2] * w[2]).astype(np.uint8)
    got = aug.grayscale(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.repeat(g[..., None], 3, -1))
    np.testing.assert_array_equal(got, np.asarray(jaug.grayscale(jnp.asarray(x))))
    fl = aug.grayscale(torch.from_numpy(f / 255.0))
    assert fl.dtype == torch.float32 and fl.shape == (B, SIZE, SIZE, 3)


def test_random_convolution_is_one_grouped_conv_scaled_by_f32_inverse_255():
    """The port's per-image convolution equals a loop of per-image convs
    on ``x · f32(1/255)``; a true division by 255 would differ."""
    x = images(3)
    w = torch.rand((B, 3, 3, 3, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
    got = aug.random_convolution(None, torch.from_numpy(x), weights=w)
    f = torch.from_numpy(x).float() * torch.tensor(np.float32(1) / np.float32(255))
    loop = torch.stack([
        torch.nn.functional.conv2d(f[i].permute(2, 0, 1)[None], w[i].permute(3, 2, 0, 1),
                                   padding=1)[0].permute(1, 2, 0) for i in range(B)])
    ref = (loop.abs().clamp(0, 1) * 255.0).to(torch.uint8)
    assert (got.int() - ref.int()).abs().max() <= 1
    assert (got != ref).float().mean() <= 1e-4
    assert aug._INV_255 == float(np.float32(1) / np.float32(255))


def test_augmentations_draw_within_their_bounds():
    """The port's own draws: cutout's sizes in [min_cut, max_cut), its
    offsets in [0, H − max_cut) and its colour in [0, 255) (half-open, as
    ``jax.random.randint``); every augmentation keeps the batch's shape
    (crop and translate resize) and dtype."""
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(images())
    for name, (args, _, c) in CASES.items():
        xi = x[..., :c]
        out = aug.AUGMENTATIONS[name](gen, xi, *args)
        side = {"crop": 20, "translate": 40}.get(name, SIZE)
        assert out.shape == (B, side, side, c) and out.dtype == torch.uint8, name
    lo, hi = 3, 9
    draws = [aug._randint(gen, lo, hi, (4000,), "cpu"), aug._randint(gen, 0, 255, (4000,), "cpu")]
    assert draws[0].min() == lo and draws[0].max() == hi - 1 and draws[1].max() == 254
    plain = torch.zeros((B, 16, 16, 3), dtype=torch.uint8)
    cut = aug.random_cutout_color(gen, plain + 255, 2, 6)
    boxes = (cut != 255).any(-1)
    # rows and columns < h0 + size ≤ (16 − 6 − 1) + (6 − 1) = 14
    assert boxes.any() and not boxes[:, 14:, :].any() and not boxes[:, :, 14:].any()


def test_augmentations_on_float_batches():
    x = torch.from_numpy(images(3).astype(np.float32) / 255.0)
    jx = jnp.asarray(x.numpy())
    key = jax.random.PRNGKey(3)
    for name in ("crop", "flip", "rotation", "cutout"):
        args, kw, _ = CASES[name]
        draws = jax_draws(name, key, x.numpy(), **kw)
        got = aug.AUGMENTATIONS[name](None, x, *args, **draws)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jaug.AUGMENTATIONS[name](
            key, jx, *args)))


# -- encoders ---------------------------------------------------------------------


@pytest.mark.parametrize("size,table", [(64, enc.OUT_DIM_64), (84, enc.OUT_DIM_84),
                                        (100, enc.OUT_DIM_100), (128, enc.OUT_DIM_128)])
def test_conv_stack_output_shape_gives_the_out_dim_tables(size, table):
    for layers, out in table.items():
        assert enc.pixel_encoder_out_hw(size, layers) == out
        assert conv_stack_output_shape(size, [3] * layers, [2] + [1] * (layers - 1),
                                       [0] * layers) == out
    assert table == getattr(jenc, f"OUT_DIM_{size}")
    e = enc.PixelEncoder((size, size, 9), device="cpu")
    assert e.fc.in_features == table[4] ** 2 * 32


def jax_encoder():
    return jenc.PixelEncoder(feature_dim=FEAT, num_layers=LAYERS, num_filters=FILTERS)


def port_encoder():
    return enc.PixelEncoder((SIZE, SIZE, C), FEAT, LAYERS, FILTERS, device="cpu")


def obs_action(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, SIZE, SIZE, C).astype(np.float32),
            np.tanh(rs.randn(B, ACT)).astype(np.float32))


def load(module, params):
    module.load_state_dict(enc.state_dict_from_jax_encoder_params({"params": params}), strict=True)
    return module


def assert_close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * scale, np.abs(got - ref).max() / scale


def assert_grads_close(module, jax_grads):
    """Every parameter's gradient within ``REL`` of the module's largest
    |gradient| (a parameter whose gradient is 0 in exact arithmetic, such
    as a bias before a softmax over the pixels, holds f32 noise)."""
    ref = enc.state_dict_from_jax_encoder_params(jax_grads)
    grads = {n: p.grad for n, p in module.named_parameters()}
    assert set(grads) == set(ref)
    scale = max(float(r.abs().max()) for r in ref.values())
    for n, g in grads.items():
        g = torch.zeros_like(ref[n]) if g is None else g
        assert float((g.double() - ref[n].double()).abs().max()) <= REL * scale, n


@pytest.fixture(scope="module")
def critic():
    jc = jenc.EncoderCritic(jax_encoder(), hidden_sizes=HIDDEN)
    o, a = obs_action()
    params = seeded_params(jc.init, o, a, seed=1)
    pc = load(enc.EncoderCritic(port_encoder(), ACT, HIDDEN), params)
    return jc, params, pc


def test_encoder_critic_tree_is_one_shared_encoder_and_round_trips(critic):
    jc, params, pc = critic
    assert sorted(params) == ["encoder", "qf1", "qf2"]
    assert sorted(params["qf1"]["head"]) == ["fc0", "last_fc"]
    assert params["encoder"]["fc"]["kernel"].shape == (13 * 13 * FILTERS, FEAT) == (1352, 16)
    assert pc.encoder.fc.in_features == 1352
    assert len([n for n, _ in pc.named_modules() if n.endswith("conv0")]) == 1
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           enc.jax_encoder_params_from_state_dict(pc.state_dict()),
                           {"params": params})


@pytest.mark.parametrize("detach", [False, True])
def test_encoder_critic_forward_and_gradients_match_jax(critic, detach):
    """A twin-Q TD-style loss: outputs and every gradient within 1e-5; with
    ``detach`` the convs' gradients are exactly 0 and ``fc``'s are not."""
    jc, params, pc = critic
    o, a = obs_action(2)
    target = np.random.RandomState(3).randn(B, 1).astype(np.float32)

    def jloss(p):
        q1, q2 = jc.apply({"params": p}, o, a, detach_encoder=detach)
        return jnp.mean((q1 - target) ** 2) + jnp.mean((q2 - target) ** 2), (q1, q2)

    (jl, (jq1, jq2)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    pc.zero_grad(set_to_none=True)
    q1, q2 = pc(torch.from_numpy(o), torch.from_numpy(a), detach_encoder=detach)
    tt = torch.from_numpy(target)
    loss = ((q1 - tt) ** 2).mean() + ((q2 - tt) ** 2).mean()
    loss.backward()
    assert_close(q1.detach(), jq1)
    assert_close(q2.detach(), jq2)
    assert_close(loss.item(), float(jl))
    assert_grads_close(pc, jg)
    conv = pc.encoder.conv0.weight.grad
    assert (conv is None or conv.abs().max() == 0) if detach else (conv.abs().max() > 0)
    assert pc.encoder.fc.weight.grad.abs().max() > 0
    assert pc.encoder.ln.weight.grad.abs().max() > 0


def test_encoder_flattened_in_nchw_order_fails(critic):
    """Mutation: the same weights through a flatten left in NCHW order no
    longer match JAX's features."""
    jc, params, pc = critic
    o, _ = obs_action(4)
    e = pc.encoder
    ref = jax.jit(lambda p, x: jc.encoder.apply({"params": p}, x))(params["encoder"], o)
    with torch.no_grad():
        assert_close(e(torch.from_numpy(o)), ref)
        h = torch.from_numpy(o).permute(0, 3, 1, 2)
        for i in range(LAYERS):
            h = torch.relu(getattr(e, f"conv{i}")(h))
        wrong = torch.tanh(e.ln(e.fc(h.reshape(B, -1))))
    with pytest.raises(AssertionError):
        assert_close(wrong, ref)


def test_encoder_q_and_v_functions_match_jax():
    o, a = obs_action(5)
    jq = jenc.EncoderQfunction(jax_encoder(), hidden_sizes=HIDDEN)
    qp = seeded_params(jq.init, o, a, seed=6)
    assert sorted(qp) == ["encoder", "head"]
    pq = load(enc.EncoderQfunction(port_encoder(), ACT, HIDDEN), qp)
    jv = jenc.EncoderVFunction(jax_encoder(), hidden_sizes=HIDDEN)
    vp = seeded_params(jv.init, o, seed=7)
    pv = load(enc.EncoderVFunction(port_encoder(), HIDDEN), vp)
    with torch.no_grad():
        assert_close(pq(torch.from_numpy(o), torch.from_numpy(a)), jq.apply({"params": qp}, o, a))
        assert_close(pv(torch.from_numpy(o)), jv.apply({"params": vp}, o))


@pytest.fixture(scope="module")
def policy():
    jp = jenc.TanhGaussianPolicyWithEncoder(jax_encoder(), action_dim=ACT, hidden_sizes=HIDDEN)
    o, _ = obs_action()
    params = seeded_params(jp.init, o, seed=8)
    pp = load(enc.TanhGaussianPolicyWithEncoder(port_encoder(), ACT, HIDDEN), params)
    return jp, params, pp


def test_policy_with_encoder_tree_and_sample_match_jax(policy):
    jp, params, pp = policy
    assert sorted(params) == ["encoder", "head"]
    assert sorted(params["head"]) == ["fc0", "last_fc", "last_fc_log_std"]
    o, _ = obs_action(9)
    key = jax.random.PRNGKey(10)
    jdist = jp.apply({"params": params}, o)
    ja, jlp = jdist.sample_and_log_prob(key)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, ACT))))
    with torch.no_grad():
        a, lp = pp(torch.from_numpy(o)).sample_and_log_prob(eps=eps)
    assert_close(a, ja)
    assert_close(lp, jlp)


@pytest.mark.parametrize("detach", [None, False])
def test_policy_with_encoder_detaches_by_default(policy, detach):
    """Gradients of a log-prob loss match JAX's, whose policy detaches its
    encoder by default: the convs get exactly 0. A policy that did not
    detach by default (the ``False`` case, against JAX's default) gets
    non-zero conv gradients and fails the comparison."""
    jp, params, pp = policy
    o, _ = obs_action(11)
    key = jax.random.PRNGKey(12)
    eps = np.array(jax.random.normal(key, (B, ACT)))

    def jloss(p):
        _, lp = jp.apply({"params": p}, o).sample_and_log_prob(key)
        return jnp.mean(lp)

    jg = jax.jit(jax.grad(jloss))(params)
    pp.zero_grad(set_to_none=True)
    kw = {} if detach is None else dict(detach_encoder=detach)
    _, lp = pp(torch.from_numpy(o), **kw).sample_and_log_prob(eps=torch.from_numpy(eps))
    lp.mean().backward()
    conv = pp.encoder.conv0.weight.grad
    if detach is None:
        assert conv is None or conv.abs().max() == 0
        assert_grads_close(pp, jg)
    else:
        assert conv.abs().max() > 0
        with pytest.raises(AssertionError):
            assert_grads_close(pp, jg)


def test_curl_logits_loss_and_gradients_match_jax():
    jc = jenc.CURL(jax_encoder())
    o, _ = obs_action(13)
    o_pos = np.clip(o + 0.05 * np.random.RandomState(14).randn(*o.shape), 0, 1).astype(np.float32)
    params = seeded_params(jc.init, o, o_pos, seed=15)
    assert sorted(params) == ["W", "encoder"]
    pc = load(enc.CURL(port_encoder()), params)

    def jloss(p):
        logits = jc.apply({"params": p}, o, o_pos)
        return jenc.curl_loss(logits), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    logits = pc(torch.from_numpy(o), torch.from_numpy(o_pos))
    loss = enc.curl_loss(logits)
    loss.backward()
    assert_close(logits.detach(), jlogits)
    assert float(logits.detach().max()) <= 0.0 and (logits.detach().max(1).values == 0).all()
    assert_close(loss.item(), float(jl))
    assert_grads_close(pc, jg)
    ref = -torch.log_softmax(logits.detach(), 1)[torch.arange(B), torch.arange(B)].mean()
    assert_close(loss.item(), ref.item())


def test_encoders_default_to_the_card():
    if torch.cuda.is_available():
        assert next(enc.PixelEncoder((SIZE, SIZE, C), FEAT).parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            enc.PixelEncoder((SIZE, SIZE, C), FEAT)


# -- misc nets --------------------------------------------------------------------


def test_spatial_softmax_matches_jax_and_localizes_a_peak():
    f = np.random.RandomState(16).randn(B, 9, 7, 4).astype(np.float32)
    for temp in (1.0, 0.5):
        assert_close(spatial_softmax(torch.from_numpy(f), temp),
                     jax.jit(jax_spatial_softmax, static_argnums=1)(f, temp))
    peak = np.full((1, 9, 9, 1), -10.0, np.float32)
    peak[0, 2, 6, 0] = 10.0  # row 2 (y), column 6 (x)
    kp = spatial_softmax(torch.from_numpy(peak), 0.1).numpy()
    np.testing.assert_allclose(kp[0], [np.linspace(-1, 1, 9)[6], np.linspace(-1, 1, 9)[2]],
                               atol=1e-3)


def test_feat_point_mlp_matches_jax():
    jm = JaxFeatPointMlp(num_feat_points=8, input_channels=3, downsample_size=4,
                         temperature=0.5)
    x = np.random.RandomState(17).rand(2, SIZE, SIZE, 3).astype(np.float32)
    params = seeded_params(jm.init, x, seed=18)
    pm = FeatPointMlp(8, 3, 4, 0.5, device="cpu")
    pm.load_state_dict(state_dict_from_jax_misc_params({"params": params}), strict=True)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax_misc_params_from_state_dict(pm.state_dict()), {"params": params})

    def jloss(p):
        out = jm.apply({"params": p}, x)
        return jnp.mean(out ** 2), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    out = pm(torch.from_numpy(x))
    (out ** 2).mean().backward()
    assert out.shape == (2, 4, 4, 3)
    assert_close(out.detach(), jout)
    assert_grads_close(pm, jg)
    with torch.no_grad():
        assert_close(pm.encode(torch.from_numpy(x)),
                     jm.apply({"params": params}, x, method=JaxFeatPointMlp.encode))


@pytest.mark.parametrize("tower", ["state_net", "image_net"])
def test_image_state_switches_match_jax(tower):
    img_dim, state_dim = 12, 4
    rs = np.random.RandomState(19)
    x = rs.randn(3, img_dim + state_dim).astype(np.float32)
    a = rs.randn(3, 2).astype(np.float32)
    in_dim = img_dim if tower == "image_net" else state_dim
    for jcls, pcls, args, extra in ((JaxImageStatePolicy, ImageStatePolicy, (x,), 0),
                                    (JaxImageStateQ, ImageStateQ, (x, a), 2)):
        jm = jcls(image_dim=img_dim, **{tower: JaxMlp(hidden_sizes=(8,), output_size=2)})
        params = seeded_params(jm.init, *args, seed=20)
        assert sorted(params) == [tower]
        pm = pcls(image_dim=img_dim, **{tower: Mlp(in_dim + extra, (8,), 2)})
        pm.load_state_dict(state_dict_from_jax_misc_params({"params": params}), strict=True)
        with torch.no_grad():
            assert_close(pm(*map(torch.from_numpy, args)), jm.apply({"params": params}, *args))
    with pytest.raises(ValueError):
        ImageStatePolicy()
    with pytest.raises(ValueError):
        ImageStateQ(Mlp(2, (2,), 1), Mlp(2, (2,), 1))


@pytest.mark.parametrize("freeze", [True, False])
def test_pretrained_cnn_matches_jax(freeze):
    """The head's output and gradients, and the input's gradient: 0 when
    frozen (a ``detach``, JAX's ``stop_gradient``), the chain rule when not."""
    x = np.random.RandomState(21).randn(2, 4, 4, 1).astype(np.float32)
    jm = JaxPretrainedCNN(feature_fn=lambda v: v.reshape(v.shape[0], -1) ** 2, hidden_sizes=(8,),
                          output_size=2, freeze_features=freeze)
    params = seeded_params(jm.init, x, seed=22)
    pm = PretrainedCNN(lambda v: v.reshape(v.shape[0], -1) ** 2, 16, (8,), 2,
                       freeze_features=freeze, device="cpu")
    pm.load_state_dict(state_dict_from_jax_misc_params({"params": params}), strict=True)
    assert sorted(dict(pm.named_children())) == ["head"]

    def jloss(p, v):
        return jnp.sum(jm.apply({"params": p}, v) ** 2)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    (pm(xt) ** 2).sum().backward()
    assert_grads_close(pm, jgp)
    gx = xt.grad if xt.grad is not None else torch.zeros_like(xt)
    if freeze:
        np.testing.assert_array_equal(gx.numpy(), 0)
    else:
        assert_close(gx, jgx)
    assert (np.abs(np.asarray(jgx)).max() == 0) == freeze
