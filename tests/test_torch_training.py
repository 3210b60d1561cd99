"""The port's GAN trainer against the JAX package's.

One ``train_step`` from the same seeded G, D and VGG weights and the same
uint8 batch, with R1 on: its metrics are held to the JAX
``GANTrainer._step`` at 1e-4, its D gradients to ``jax.value_and_grad`` of
the D loss built from the JAX package's public functions as ``_update``
builds it, and its G gradients to that of the G loss, taken against the
port's post-update D weights (Adam's first step is ≈ lr·sign(g), so two D
updates that differ by float noise can differ by ±lr in a weight whose
gradient is near zero). Gradient tolerance, per tensor: 1e-4 of the
largest |gradient| of the whole module plus 1e-3 of the tensor's own
(f32 on the CPU, two frameworks' summation orders)."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.gan import GANTrainer as JaxTrainer
from s2p_tpu.gan import S2PGenerator as JaxGenerator
from s2p_tpu.gan import losses as jl
from s2p_tpu.gan.discriminator import MultiscaleDiscriminator as JaxDiscriminator
from s2p_tpu.gan.perceptual import PerceptualLoss as JaxPerceptualLoss
from s2p_tpu.gan.perceptual import VGG19Features as JaxVGG19Features
from s2p_tpu.gan.training import TrainState
from s2p_tpu_torch.gan import S2PGenerator
from s2p_tpu_torch.gan.convert import jax_params_from_state_dict, state_dict_from_jax_params
from s2p_tpu_torch.gan.discriminator import MultiscaleDiscriminator
from s2p_tpu_torch.gan.losses import GANLossConfig
from s2p_tpu_torch.gan.perceptual import PerceptualLoss
from s2p_tpu_torch.gan.training import GANOptConfig, GANTrainer, _to_signed

from test_torch_discriminator import D_KW, disc_params
from test_torch_generator import KW, STATE_DIM, jax_params, seeded_params

SIZE = 25
LOSS_CFG = dict(r1_gamma=1.0, r1_interval=16)


def uint8_batch(batch=2, size=SIZE, seed=0):
    rs = np.random.RandomState(seed)
    return dict(prev_image=rs.randint(0, 256, (batch, size, size, 3), dtype=np.uint8),
                state=rs.randn(batch, STATE_DIM).astype(np.float32),
                target_image=rs.randint(0, 256, (batch, size, size, 3), dtype=np.uint8))


def tiny_trainer(**kw):
    kw = dict(dict(image_size=SIZE, generator_kwargs=KW, discriminator_kwargs=D_KW,
                   device="cpu"), **kw)
    return GANTrainer.create(STATE_DIM, **kw)


@pytest.fixture(scope="module")
def shared():
    """Seeded JAX params of G, D and VGG, and the port's trainer holding the
    same weights."""
    jgen = JaxGenerator(image_size=SIZE, **KW)
    jdisc = JaxDiscriminator(**D_KW)
    g_params = jax_params(jgen, seed=1)
    d_params = disc_params(jdisc, SIZE, seed=2)
    vgg_params = seeded_params(JaxVGG19Features().init, jnp.zeros((1, SIZE, SIZE, 3)), seed=3)
    return jgen, jdisc, g_params, d_params, vgg_params


def port_trainer(shared):
    _, _, g_params, d_params, vgg_params = shared
    gen = S2PGenerator(STATE_DIM, image_size=SIZE, device="cpu", **KW)
    gen.load_state_dict(state_dict_from_jax_params(g_params), strict=True)
    disc = MultiscaleDiscriminator(STATE_DIM, device="cpu", **D_KW)
    disc.load_state_dict(state_dict_from_jax_params(d_params), strict=True)
    perceptual = PerceptualLoss(state_dict_from_jax_params(vgg_params), device="cpu")
    return GANTrainer(gen, disc, perceptual, GANLossConfig(**LOSS_CFG))


def assert_grads_close(module, jax_grads):
    ref = state_dict_from_jax_params(jax_grads)
    grads = dict(module.named_parameters())
    assert sorted(ref) == sorted(grads)
    scale = max(v.abs().max().item() for v in ref.values())
    for k, r in ref.items():
        err = (grads[k].grad - r).abs().max().item()
        assert err <= 1e-4 * scale + 1e-3 * r.abs().max().item(), (k, err, scale)


def test_train_step_matches_jax(shared):
    jgen, jdisc, g_params, d_params, vgg_params = shared
    cfg = jl.GANLossConfig(**LOSS_CFG)
    jloss = JaxPerceptualLoss({"params": vgg_params})
    adam = lambda lr: optax.adam(lr, b1=0.0, b2=0.999)
    jtrainer = JaxTrainer(
        jgen, jdisc,
        TrainState.create(apply_fn=jgen.apply, params={"params": g_params}, tx=adam(1e-4)),
        TrainState.create(apply_fn=jdisc.apply, params={"params": d_params}, tx=adam(4e-4)),
        jloss, cfg)
    batch = uint8_batch()
    _, _, ref_metrics = jtrainer._step(jtrainer.g_state, jtrainer.d_state, batch)

    trainer = port_trainer(shared)
    metrics = trainer.train_step(batch)
    assert sorted(metrics) == sorted(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    assert metrics["d_r1"].item() > 0 and (trainer.g_step, trainer.d_step) == (1, 1)

    # the gradients of that step, against jax.value_and_grad of the losses
    prev = batch["prev_image"] / 127.5 - 1.0
    real = batch["target_image"] / 127.5 - 1.0
    state = batch["state"]
    fake = jgen.apply({"params": g_params}, state, prev)

    def d_loss_fn(dp):
        rf = jdisc.apply(dp, state, prev, real)
        ff = jdisc.apply(dp, state, prev, fake)

        def real_logit_mean(img):
            feats = jl.logits_of(jdisc.apply(dp, state, prev, img))
            return jnp.sum(sum(jnp.mean(x, axis=(1, 2, 3)) for x in feats) / len(feats))

        r1 = jl.r1_penalty(jax.grad(real_logit_mean)(real))
        loss = jl.hinge_d_loss(jl.logits_of(rf), jl.logits_of(ff))
        return loss + 0.5 * cfg.r1_gamma * cfg.r1_interval * r1

    d_loss, d_grads = jax.jit(jax.value_and_grad(d_loss_fn))({"params": d_params})
    assert metrics["d_loss"].item() == pytest.approx(float(d_loss), rel=1e-4)
    assert_grads_close(trainer.discriminator, d_grads["params"])

    d_post = {"params": jax_params_from_state_dict(trainer.discriminator.state_dict())}

    def g_loss_fn(gp):
        fk = jgen.apply(gp, state, prev)
        ff = jdisc.apply(d_post, state, prev, fk)
        rf = jdisc.apply(d_post, state, prev, real)
        return (cfg.lambda_gan * jl.hinge_g_loss(jl.logits_of(ff))
                + cfg.lambda_feat * jl.feature_matching_loss(rf, ff)
                + cfg.lambda_l1 * jl.l1_loss(fk, real) + cfg.lambda_vgg * jloss(fk, real))

    g_loss, g_grads = jax.jit(jax.value_and_grad(g_loss_fn))({"params": g_params})
    assert metrics["g_loss"].item() == pytest.approx(float(g_loss), rel=1e-4)
    assert_grads_close(trainer.generator, g_grads["params"])
    assert all(p.grad.abs().max() > 0 for p in trainer.generator.parameters())


def test_adam_matches_optax():
    rs = np.random.RandomState(0)
    p0 = rs.randn(5, 7).astype(np.float32)
    grads = [rs.randn(5, 7).astype(np.float32) for _ in range(3)]
    cfg = GANOptConfig()
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([param], lr=cfg.g_lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    tx = optax.adam(cfg.g_lr, b1=cfg.beta1, b2=cfg.beta2)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    trainer = tiny_trainer(use_perceptual=False)
    assert trainer.g_opt.defaults["betas"] == (0.0, 0.999) and trainer.g_opt.defaults["eps"] == 1e-8
    assert (trainer.g_opt.defaults["lr"], trainer.d_opt.defaults["lr"]) == (1e-4, 4e-4)


def test_r1_and_d_every_cadence():
    """d_every=2 with r1_interval=3: R1 fires on every 3rd performed D update
    (D updates at G steps 0, 2, 4, ...; R1 at D steps 0, 3, 6 → G steps 0, 6,
    12), as tests/test_gan.py::test_gan_trainer_r1_misaligned_cadence expects
    of the JAX trainer."""
    trainer = tiny_trainer(use_perceptual=False, d_every=2,
                           discriminator_kwargs=dict(ndf=8, n_layers=2, num_scales=1),
                           loss_cfg=GANLossConfig(r1_gamma=1.0, r1_interval=3))
    batch = uint8_batch(seed=3)
    r1s, d_losses = [], []
    for _ in range(14):
        m = trainer.train_step(batch)
        r1s.append(m["d_r1"].item())
        d_losses.append(m["d_loss"].item())
    assert [i for i, v in enumerate(r1s) if v > 0.0] == [0, 6, 12]
    assert [i for i, v in enumerate(d_losses) if v != 0.0] == list(range(0, 14, 2))
    assert (trainer.g_step, trainer.d_step) == (14, 7)


def test_bf16_step_on_cpu():
    trainer = tiny_trainer(compute_dtype=torch.bfloat16,
                           loss_cfg=GANLossConfig(r1_gamma=1.0))
    metrics = trainer.train_step(uint8_batch(seed=4))
    assert all(torch.isfinite(v) and v.dtype == torch.float32 for v in metrics.values())
    for module in (trainer.generator, trainer.discriminator):
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in module.parameters())
    assert all(s["exp_avg"].dtype == torch.float32 for s in trainer.g_opt.state.values())


def test_train_many_is_deterministic_for_a_seed():
    data = {k: torch.from_numpy(v) for k, v in uint8_batch(batch=6, seed=5).items()}

    def run(seed):
        trainer = tiny_trainer(use_perceptual=False)
        m = trainer.train_many(data, 3, 2, torch.Generator().manual_seed(seed))
        return m, trainer

    (m1, t1), (m2, t2), (m3, _) = run(0), run(0), run(1)
    assert sorted(m1) == ["d_loss", "g_adv", "g_fm", "g_l1", "g_loss", "g_vgg"]
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert any(not torch.equal(m1[k], m3[k]) for k in m1)
    assert t1.g_step == 3
    for p, q in zip(t1.generator.parameters(), t2.generator.parameters()):
        assert torch.equal(p, q)


def test_to_signed_and_generate():
    u8 = torch.tensor([[0, 255]], dtype=torch.uint8)
    assert torch.equal(_to_signed(u8), torch.tensor([[-1.0, 1.0]]))
    trainer = tiny_trainer(use_perceptual=False)
    b = uint8_batch(seed=6)
    out = trainer.generate(torch.from_numpy(b["state"]), _to_signed(torch.from_numpy(
        b["prev_image"])))
    assert out.shape == (2, SIZE, SIZE, 3) and out.grad_fn is None
    assert dataclasses.asdict(GANOptConfig()) == dict(g_lr=1e-4, d_lr=4e-4, beta1=0.0,
                                                      beta2=0.999)
