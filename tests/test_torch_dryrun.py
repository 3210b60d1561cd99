"""The port's counterpart of ``__graft_entry__.py`` (``s2p_tpu_torch.cli.
dryrun``) on the CPU.

- ``entry(device="cpu")`` with the weights JAX's ``entry()`` makes (flax's
  ``init`` from ``PRNGKey(0)``, built here as ``__graft_entry__`` builds
  them, since importing it would set ``XLA_FLAGS`` for the whole process)
  against JAX's forward on seeded non-zero inputs of entry's shapes,
  within 1e-4, the generator's CPU tolerance.
- ``dryrun_multichip`` on 2 and on 4 gloo ranks (one spawn each, run while
  JAX initialises its generator): every leg's line, finite losses, G's step
  counter at 3 after ``train_many_dp``, every trained leg's parameters
  bit-equal on all ranks, the state legs within ``STATE_TOL`` of one
  process's ``train_many``, the tensor-parallel leg on a 2 × 2 mesh within
  1e-4 of the unsharded forward, and the GAN leg's losses at world 2 equal
  to one process's ``train_step`` on the whole global batch within 1e-5
  relative.
- Without CUDA, both raise unless the caller asks for the CPU.
"""

import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.gan import S2PGenerator as JaxGenerator
from s2p_tpu_torch.cli import dryrun
from s2p_tpu_torch.gan.convert import state_dict_from_jax_params
from s2p_tpu_torch.testing import dryrun_worker

ENTRY_TOL = 1e-4
LOSS_RTOL = 1e-5
LEGS = ("GAN ok", "IQL+SLAC ok", "GAN DP scan ok", "scanned IQL/CQL ok", "scanned IMAGE-RL ok")


@pytest.fixture(scope="module")
def runs():
    """The dry run at world 2 and 4, JAX's ``entry()`` weights and its
    forward on seeded inputs."""
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(lambda: {n: dryrun.dryrun_multichip(n, device="cpu")
                                       for n in (2, 4)})
        jgen = JaxGenerator(image_size=64, ngf=64)
        params = jgen.init(jax.random.PRNGKey(0), jnp.zeros((8, dryrun.STATE_DIM)),
                           jnp.zeros((8, 64, 64, 3)))
        rs = np.random.RandomState(0)
        state = rs.randn(8, dryrun.STATE_DIM).astype(np.float32)
        prev = (rs.rand(8, 64, 64, 3) * 2 - 1).astype(np.float32)
        ref = np.asarray(jax.jit(jgen.apply)(params, state, prev))
        out = spawned.result()
    out["entry"] = dict(params=params["params"], state=state, prev=prev, ref=ref)
    return out


def leg(run, rank, name):
    (rec,) = [r for r in run["ranks"][rank]["legs"] if r["name"] == name]
    return rec


def test_entry_matches_jax_entry(runs):
    e = runs["entry"]
    fn, (state0, prev0) = dryrun.entry(device="cpu",
                                       state_dict=state_dict_from_jax_params(e["params"]))
    assert state0.shape == (8, dryrun.STATE_DIM) and prev0.shape == (8, 64, 64, 3)
    assert not state0.any() and not prev0.any() and state0.device.type == "cpu"
    out = fn(torch.from_numpy(e["state"]), torch.from_numpy(e["prev"])).numpy()
    assert np.isfinite(out).all() and np.abs(out).max() > 0.1
    np.testing.assert_allclose(out, e["ref"], rtol=0, atol=ENTRY_TOL)


def test_entry_default_weights_on_the_cpu():
    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (8, 64, 64, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_prints_every_leg(runs, world):
    lines = runs[world]["lines"]
    tp = world % 2 == 0 and world >= 4
    assert len(lines) == len(LEGS) + tp
    for line, text in zip(lines, LEGS + (("TP generator ok",) if tp else ())):
        assert line.startswith(f"dryrun_multichip({world}): {text}"), line
        assert f"gloo; {world} ranks on cpu" in line, line
    for rank in runs[world]["ranks"]:
        assert rank["backend"] == "gloo" and rank["device"] == "cpu"
        for rec in rank["legs"]:
            assert all(np.isfinite(v) for v in rec["metrics"].values()), rec
            assert rec["launches"] == (0, 0)  # the plain norm on the CPU counts nothing


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_step_counter_and_synced_metrics(runs, world):
    """G takes 3 steps (1 + 2 in ``train_many_dp``); every leg that trains
    leaves the ranks' parameters bit-equal (their gradients were averaged:
    metrics alone are averaged after the step, so they agree either way),
    and every rank reports the same metrics."""
    ranks = runs[world]["ranks"]
    assert leg(runs[world], 0, "gan_dp_scan")["metrics"]["g_step"] == 3
    for name in ("gan", "iql_slac", "gan_dp_scan", "state_rl", "image_rl"):
        digests = {leg(runs[world], r, name)["digest"] for r in range(world)}
        assert len(digests) == 1 and None not in digests, name
        assert len({tuple(leg(runs[world], r, name)["metrics"].items())
                    for r in range(world)}) == 1, name
    assert len({leg(runs[world], 0, n)["digest"] for n in ("gan", "gan_dp_scan")}) == 2
    assert len(ranks) == world


@pytest.mark.parametrize("world", [2, 4])
def test_state_legs_match_one_process(runs, world):
    """The state IQL and CQL legs against one process's ``train_many`` on
    the whole global batches and CQL draws (the ranks take their rows)."""
    m = leg(runs[world], 0, "state_rl")["metrics"]
    for algo in ("iql", "cql"):
        assert 0 <= m[f"err_{algo}"] <= dryrun_worker.STATE_TOL, (algo, m)
    assert "vs one process max|Δ|=" in runs[world]["lines"][3]


def test_tp_leg_on_a_2x2_mesh(runs):
    line = runs[4]["lines"][-1]
    assert "TP generator ok  mesh={'data': 2, 'model': 2}" in line
    err = float(re.search(r"max\|Δ\|=(\S+)", line).group(1))
    assert err < 1e-4
    for r in range(4):
        rec = leg(runs[4], r, "tp")["metrics"]
        assert rec["max_abs_err"] < 1e-4 and rec["sharded"] > 0
    assert all(r["name"] != "tp" for r in runs[2]["ranks"][0]["legs"])


def test_gan_leg_equals_the_single_process_step(runs):
    """World 2 on the two halves of the global batch against one process's
    ``train_step`` on all of it, from the same seeded trainer."""
    torch.manual_seed(0)
    trainer = dryrun_worker.gan_trainer("cpu", None)
    batch = dryrun_worker.gan_batch(np.random.RandomState(0), 4)
    ref = {k: v.item() for k, v in trainer.train_step(batch).items()}
    got = leg(runs[2], 0, "gan")["metrics"]
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=k)


def test_without_cuda_the_card_paths_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["2"])


def test_main_defaults(monkeypatch):
    """``python -m s2p_tpu_torch.cli.dryrun``: N is the number of cards, or
    2 on the CPU; an explicit N wins."""
    calls = []
    monkeypatch.setattr(dryrun, "dryrun_multichip", lambda n, dev: calls.append((n, dev)))
    dryrun.main(["--device", "cpu"])
    dryrun.main(["3", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    dryrun.main([])
    assert calls == [(2, torch.device("cpu")), (3, torch.device("cpu")), (4, torch.device("cuda"))]
