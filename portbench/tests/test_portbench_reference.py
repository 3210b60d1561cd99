"""The plain reference against the port at a tiny size on the CPU: the same
weights and inputs give the same frames, losses, gradients and updates."""

import torch

from conftest import tiny_cell
from portbench import compare, harness, program
from portbench.reference import nets
from portbench.reference.precision import Precision
from portbench.reference.train import train_steps

F32 = Precision("f32")


def test_generator_matches_the_port():
    cfg = tiny_cell("walker100-bridge-b256").config
    W = harness.seeded_weights(nets.generator_spec(cfg), torch.Generator().manual_seed(1), "cpu")
    gen = program.build_generator(cfg, W, "cpu", torch.float32)
    g = torch.Generator().manual_seed(2)
    state = torch.randn(3, cfg["state_dim"], generator=g)
    prev = torch.rand(3, 25, 25, 3, generator=g) * 2 - 1
    with torch.no_grad():
        torch.testing.assert_close(nets.generator(W, cfg, state, prev, F32), gen(state, prev),
                                   rtol=1e-4, atol=1e-5)


def test_fast_path_matches_the_reference():
    from s2p_tpu_torch.gan import generate_rollout_fast

    cfg = tiny_cell("cheetah64-rollout-b256").config
    W = harness.seeded_weights(nets.generator_spec(cfg), torch.Generator().manual_seed(3), "cpu")
    gen = program.build_generator(cfg, W, "cpu", torch.float32)
    g = torch.Generator().manual_seed(4)
    states = torch.randn(3, 2, cfg["state_dim"], generator=g)
    init = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
    frames = generate_rollout_fast(gen, init, states)
    gaps = compare.rollout_gaps(cfg, W, [(init, states, frames)], "cpu", chunk=2)
    assert gaps["frame_max_gap"] < 1e-4


def test_discriminator_and_vgg_match_the_port():
    from s2p_tpu_torch.gan import MultiscaleDiscriminator
    from s2p_tpu_torch.gan.perceptual import PerceptualLoss

    cfg = tiny_cell("walker100-train-b16").config
    d = cfg["discriminator"]
    gen = torch.Generator().manual_seed(5)
    Wd = harness.seeded_weights(nets.discriminator_spec(cfg), gen, "cpu")
    Wv = harness.seeded_weights(nets.vgg19_spec(), gen, "cpu")
    D = MultiscaleDiscriminator(cfg["state_dim"], 3, d["num_scales"], d["ndf"], d["n_layers"],
                                device="cpu")
    D.load_state_dict(Wd)
    P = PerceptualLoss(device="cpu")
    P.vgg.load_state_dict(Wv)
    state = torch.randn(2, cfg["state_dim"], generator=gen)
    a, b, c = (torch.rand(2, 25, 25, 3, generator=gen) * 2 - 1 for _ in range(3))
    with torch.no_grad():
        for mine, theirs in zip(nets.discriminator(Wd, cfg, state, a, b, F32), D(state, a, b)):
            for x, y in zip(mine, theirs):
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(nets.vgg19_loss(Wv, b, c, F32), P(b, c), rtol=1e-4, atol=1e-6)


def test_training_steps_match_the_port():
    """Three float32 steps of the port's trainer (the first with R1) against
    the reference: losses, first gradients and parameters."""
    cell = tiny_cell("walker100-train-b16", precision="f32-tf32")
    drv = cell.driver
    ctx = harness.Ctx(cell, 7, torch.device("cpu"))
    prog = drv.setup(ctx)
    judged = prog.finish()
    ref = compare.reference_training(cell.config, judged["weights"], judged["batches"], F32,
                                     "cpu")
    gaps = compare.train_gaps(judged["readings"], ref)
    assert gaps["fm_loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-3
    for p, r in zip(judged["readings"]["losses"], ref["losses"]):  # every step and term
        for k, v in r.items():
            assert abs(p[k] - v) <= 1e-5 * abs(v) + 1e-7, (k, p[k], v)
    assert len(judged["batches"]) == 3


def test_reference_train_step_moves_every_leaf():
    cfg = tiny_cell("walker100-train-b16").config
    gen = torch.Generator().manual_seed(8)
    W = {m: harness.seeded_weights(spec, gen, "cpu") for m, spec in (
        ("G", nets.generator_spec(cfg)), ("D", nets.discriminator_spec(cfg)),
        ("VGG", nets.vgg19_spec()))}
    batch = dict(prev_image=torch.randint(0, 256, (2, 25, 25, 3), dtype=torch.uint8),
                 target_image=torch.randint(0, 256, (2, 25, 25, 3), dtype=torch.uint8),
                 state=torch.randn(2, cfg["state_dim"]))
    run = train_steps(cfg, W, [batch], F32)
    for m in ("G", "D"):  # a leaf moves where its gradient is not 0
        moved = {k for k, p in run["params"][m].items() if not torch.equal(p, W[m][k])}
        assert moved == {k for k, g in run["grads"][m].items() if g.abs().max() > 0}
        assert len(moved) > 0.9 * len(W[m])
