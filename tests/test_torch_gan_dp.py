"""Data-parallel GAN training in the port: 2 gloo ranks on the CPU.

One spawn runs every case (``s2p_tpu_torch/testing/gan_dp_worker.py``); the
tests read what each rank reported. JAX's data-parallel step equals its
step on the global batch (each ``pmean`` averages equal-size means), so
the port's 2-rank step on the two halves of a global batch is held to
JAX's ``GANTrainer`` step on the whole of it, with the same converted
weights, R1 firing at every D update (``r1_interval`` 1) and D updated
every second step (``d_every`` 2): losses to 1e-5 relative, gradients to
1e-4 of the module's largest (JAX's through Adam's first moment, which
equals the gradient at β1 = 0), weights after Adam by the share that
moved. The second step starts JAX from the port's weights after the
first. Adam's first update moves a weight by lr·g/(|g| + 1e-8), ≈ ±lr
whatever |g|, so where a gradient is within its tolerance of zero the two
updates may even differ in sign (by up to 2·lr); elsewhere they agree."""

from concurrent.futures import ThreadPoolExecutor

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
from s2p_tpu_torch.gan.convert import jax_params_from_state_dict, state_dict_from_jax_params
from s2p_tpu_torch.parallel.distributed import spawn_ranks
from s2p_tpu_torch.testing import gan_dp_worker

from test_torch_discriminator import D_KW, disc_params
from test_torch_generator import KW, STATE_DIM, jax_params, seeded_params
from test_torch_training import SIZE, uint8_batch

WORLD = 2
LOSS = dict(r1_gamma=1.0, r1_interval=1)
D_EVERY = 2
G_LR, D_LR = 1e-4, 4e-4
# train_many_dp: 11 rows (the 11th dropped: 5 per rank), global batch 4, 2 steps
# with both learning rates 0
MANY_ROWS, MANY_BATCH, MANY_STEPS = 11, 4, 2
MANY_CASE = dict(loss=LOSS, opt=dict(g_lr=0.0, d_lr=0.0))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Seeded JAX weights, the global batches, every rank's results, and
    ``jax``: JAX's step on each global batch (``jax_steps``). The ranks run
    while JAX compiles its step."""
    tmp = tmp_path_factory.mktemp("gan_dp")
    jgen, jdisc = JaxGenerator(image_size=SIZE, **KW), JaxDiscriminator(**D_KW)
    g, d = jax_params(jgen, seed=1), disc_params(jdisc, SIZE, seed=2)
    vgg = seeded_params(JaxVGG19Features().init, jnp.zeros((1, SIZE, SIZE, 3)), seed=3)
    batches = [uint8_batch(batch=4, seed=10 + i) for i in range(2)]
    many = uint8_batch(batch=MANY_ROWS, seed=20)
    indices = np.random.RandomState(21).randint(0, 5, (WORLD, MANY_STEPS, MANY_BATCH // WORLD))
    case = dict(loss=LOSS, d_every=D_EVERY, batches=batches)
    spec = dict(
        state_dim=STATE_DIM, image_size=SIZE, generator_kwargs=KW, discriminator_kwargs=D_KW,
        g=state_dict_from_jax_params(g), d=state_dict_from_jax_params(d),
        vgg=state_dict_from_jax_params(vgg),
        cases=[dict(case, name="dp", kind="steps"),
               dict(case, name="no_sync", kind="steps", sync=False),
               dict(MANY_CASE, name="many_dp", kind="many_dp", data=many, indices=indices,
                    num_steps=MANY_STEPS, batch_size=MANY_BATCH),
               dict(case, name="world1", kind="world1")])
    torch.save(spec, tmp / "spec.pt")
    out = dict(jgen=jgen, jdisc=jdisc, g=g, d=d, vgg=vgg, batches=batches, many=many,
               indices=indices, spec=spec)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_ranks, gan_dp_worker.run, WORLD,
                            (str(tmp / "spec.pt"), str(tmp)), timeout=300)
        jt = jax_trainer(out)
        first = jax_step(jt, jt.g_state, jt.d_state, batches[0])
        ranks.result()
    out["ranks"] = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    # the second step from the port's (rank 0) weights after the first, at
    # the global step counts (1), with a fresh Adam
    after = result(out, "dp")["steps"][0]["weights"]
    states = []
    for state, mod in ((jt.g_state, "generator"), (jt.d_state, "discriminator")):
        params = {"params": jax_params_from_state_dict(after[mod])}
        states.append(state.replace(params=params, opt_state=state.tx.init(params), step=1))
    out["jax"] = [first[2], jax_step(jt, *states, batches[1])[2]]
    return out


def result(run, case, rank=0):
    res = run["ranks"][rank][case]
    assert "error" not in res, res.get("error")
    return res


def jax_trainer(run):
    adam = lambda lr: optax.adam(lr, b1=0.0, b2=0.999)
    jgen, jdisc = run["jgen"], run["jdisc"]
    return JaxTrainer(
        jgen, jdisc,
        TrainState.create(apply_fn=jgen.apply, params={"params": run["g"]}, tx=adam(G_LR)),
        TrainState.create(apply_fn=jdisc.apply, params={"params": run["d"]}, tx=adam(D_LR)),
        JaxPerceptualLoss({"params": run["vgg"]}), jl.GANLossConfig(**LOSS), d_every=D_EVERY)


def jax_step(jt, g_state, d_state, batch):
    """JAX's step: its states after it, and its metrics, each module's
    gradient (Adam's first moment after the step) and weights after it."""
    g_state, d_state, metrics = jt._step(g_state, d_state, batch)
    to_port = lambda tree: state_dict_from_jax_params(jax.device_get(tree)["params"])
    return g_state, d_state, dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads=dict(generator=to_port(g_state.opt_state[0].mu),
                   discriminator=to_port(d_state.opt_state[0].mu)),
        weights=dict(generator=to_port(g_state.params), discriminator=to_port(d_state.params)))


GRAD_TOL = 1e-4  # of the module's largest |gradient|


def check_weights(got, ref, ref_grads, lr: float, steps: int = 1) -> None:
    """Weights after ``steps`` Adam steps: within 1e-6 (per step) where the
    reference gradient of every step is beyond the gradient tolerance (so
    both updates are ±lr of the same sign), within 2·lr per step elsewhere."""
    for k, r in ref.items():
        determined = torch.ones_like(r, dtype=torch.bool)
        for grads in ref_grads:
            scale = max(v.abs().max().item() for v in grads.values())
            determined &= grads[k].abs() > GRAD_TOL * scale
        err = (got[k] - r).abs()
        assert (err[determined] <= 1e-6 * steps).all(), (k, err[determined].max().item())
        assert (err <= 2 * lr * steps).all(), (k, err.max().item())


def check_step(got, ref, weights: bool, d_updated: bool) -> None:
    """Losses 1e-5 relative; gradients 1e-4 of the module's largest; the
    weights after Adam by ``check_weights`` (``weights``)."""
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for mod, lr in (("generator", G_LR), ("discriminator", D_LR)):
        if mod == "discriminator" and not d_updated:
            continue
        ref_g, got_g = ref["grads"][mod], got["grads"][mod]
        scale = max(v.abs().max().item() for v in ref_g.values())
        for k, r in ref_g.items():
            err = (got_g[k] - r).abs().max().item()
            assert err <= GRAD_TOL * scale, (mod, k, err, scale)
        if weights:
            check_weights(got["weights"][mod], ref["weights"][mod], [ref_g], lr)


def test_dp_step_matches_jax_global_batch(run):
    steps = result(run, "dp")["steps"]
    assert steps[0]["metrics"]["d_r1"] > 0  # R1 fired on the first D update
    check_step(steps[0], run["jax"][0], weights=True, d_updated=True)
    # second step: D skipped (d_every 2), its weights untouched
    assert steps[1]["metrics"]["d_loss"] == 0.0 and steps[1]["metrics"]["d_r1"] == 0.0
    check_step(steps[1], run["jax"][1], weights=False, d_updated=False)
    for k, v in steps[1]["weights"]["discriminator"].items():
        assert torch.equal(v, steps[0]["weights"]["discriminator"][k]), k


def test_without_the_sync_the_step_is_not_jax(run):
    """The mutation guard: each rank stepping on its own half (no gradient
    or metric average) fails the comparison the synced step passes."""
    for rank in range(WORLD):
        with pytest.raises(AssertionError):
            check_step(result(run, "no_sync", rank)["steps"][0], run["jax"][0], weights=True,
                       d_updated=True)


def test_ranks_hold_identical_parameters(run):
    for case in ("dp", "many_dp"):
        got = [result(run, case, r) for r in range(WORLD)]
        steps = [g["steps"] if "steps" in g else [g] for g in got]
        for s0, s1 in zip(*steps):
            for mod in ("generator", "discriminator"):
                for k, v in s0["weights"][mod].items():
                    assert torch.equal(v, s1["weights"][mod][k]), (case, mod, k)
            assert s0["metrics"] == s1["metrics"]


def test_train_many_dp_equals_the_gathered_global_batch(run):
    """Rank r stages its contiguous rows [5r, 5r + 5) (the 11th row
    dropped) and steps on the rows its indices pick; the average over the
    ranks is the single-process step on the gathered global batch. Both
    learning rates are 0, so every step of both runs sees the same weights:
    the metrics averaged over the steps (1e-5 relative) and the last step's
    gradients (1e-4 of the module's largest) are held."""
    per = MANY_ROWS // WORLD
    for rank in range(WORLD):
        shard = result(run, "many_dp", rank)["shard"]
        for k, v in shard.items():
            np.testing.assert_array_equal(v.numpy(), run["many"][k][rank * per:(rank + 1) * per])
    trainer = gan_dp_worker.make_trainer(run["spec"], MANY_CASE, None)
    sums = {}
    for step in range(MANY_STEPS):
        rows = np.concatenate([rank * per + run["indices"][rank, step] for rank in range(WORLD)])
        for k, v in trainer.train_step({k: v[rows] for k, v in run["many"].items()}).items():
            sums[k] = sums.get(k, 0.0) + v.item() / MANY_STEPS
    ref = gan_dp_worker.snapshot(trainer, {k: torch.tensor(v) for k, v in sums.items()})
    check_step(result(run, "many_dp"), ref, weights=False, d_updated=True)


def test_world_one_group_is_the_single_process_step(run):
    got = result(run, "world1")
    for with_group, without in zip(got["group"], got["none"]):
        assert with_group["metrics"] == without["metrics"]
        for part in ("grads", "weights"):
            for mod, tensors in without[part].items():
                for k, v in tensors.items():
                    assert torch.equal(with_group[part][mod][k], v), (part, mod, k)


def test_train_many_dp_rejects_a_batch_that_does_not_divide(run):
    from s2p_tpu_torch.parallel import Mesh

    trainer = gan_dp_worker.make_trainer(run["spec"], {}, None)
    mesh = Mesh({"data": 2, "model": 1}, [[0], [1]], {"data": 0, "model": 0},
                {"data": None, "model": None})
    with pytest.raises(ValueError, match="does not divide"):
        trainer.train_many_dp(mesh, run["many"], 1, 3)
