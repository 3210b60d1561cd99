"""``python -m s2p_tpu_torch.cli.final_eval`` against the JAX package's
``final_eval``: the snapshot selection on one run directory, and a
deterministic walker-walk evaluation at 64px of a snapshot written by the
JAX package's logger and of one written by the port's (its trainer's
``get_snapshot``), each read by both CLIs. Per-path returns agree within
1e-3 relative (the f32 encoders and policies differ in the last bits, and
MuJoCo integrates the difference).

Both CLIs evaluate full episodes; here the walker's horizon is cut to 25
steps (the env factory each CLI calls is wrapped), since rendering a 64px
frame takes ~25 ms on the CPU."""

import csv
import functools
import os

import numpy as np
import pytest

import jax.numpy as jnp

import s2p_tpu.envs
import s2p_tpu_torch.envs
from s2p_tpu.cli import final_eval as jax_final_eval
from s2p_tpu.rl import TanhGaussianPolicy as JaxTanhGaussianPolicy
from s2p_tpu.slac import LatentModel as JaxLatentModel
from s2p_tpu.utils.logging import Logger as JaxLogger
from s2p_tpu_torch.cli import final_eval
from s2p_tpu_torch.rl import CriticSLAC, IQLTrainer, TanhGaussianPolicy
from s2p_tpu_torch.slac import SlacAlgorithm
from s2p_tpu_torch.utils.logging import Logger
from tests.test_torch_generator import seeded_params

HORIZON, HW, ACT = 25, 64, 6  # walker-walk
FULL = dict(feature_dim=256, z1_dim=32, z2_dim=256)


def write_run(run_dir, rows, snapshots):
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "progress.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    for epoch in snapshots:
        open(os.path.join(run_dir, f"itr_{epoch}.pkl"), "wb").close()
    open(os.path.join(run_dir, "params.pkl"), "wb").close()


@pytest.mark.parametrize("fresh", [True, False])
def test_snapshot_selection_matches_jax(tmp_path, fresh, capsys):
    rows = [{"epoch": e, "eval/Returns Mean": r, **({"eval/is_fresh": f} if fresh else {})}
            for e, r, f in ((-2, 5.0, 1), (-1, 9.0, 0), (0, 7.0, 1), (1, 8.0, 1), (2, 3.0, 1))]
    run = str(tmp_path / "run")
    write_run(run, rows, snapshots=(-2, -1, 0, 2))
    for snapshot in ("best", "final", "params.pkl", "itr_*.pkl", "itr_2.pkl"):
        got = final_eval.resolve_snapshot(run, snapshot)
        assert got == jax_final_eval.resolve_snapshot(run, snapshot)
    assert final_eval.select_best_snapshot(run).endswith("itr_0.pkl" if fresh else "itr_-1.pkl")
    assert capsys.readouterr().out.count("best snapshot: epoch") == 3
    for run_rows, files, exc in (([{"epoch": 0}], (0,), ValueError),
                                 ([{"epoch": 1, "eval/Returns Mean": 1.0}], (0,), ValueError)):
        bad = str(tmp_path / f"bad{len(os.listdir(tmp_path))}")
        write_run(bad, run_rows, files)
        for fn in (final_eval.select_best_snapshot, jax_final_eval.select_best_snapshot):
            with pytest.raises(exc):
                fn(bad)
    for fn in (final_eval.resolve_snapshot, jax_final_eval.resolve_snapshot):
        with pytest.raises(FileNotFoundError):
            fn(run, "itr_9.pkl")


@pytest.fixture
def short_walker(monkeypatch):
    """Both packages' ``make_dmc`` with a ``HORIZON``-step episode, and
    flax's slow ``init`` of the JAX latent replaced by seeded params (the
    snapshot overwrites them)."""
    for module in (s2p_tpu.envs, s2p_tpu_torch.envs):
        def make(*args, _orig=module.make_dmc, **kw):
            env = _orig(*args, **kw)
            env._max_episode_steps = HORIZON
            return env

        monkeypatch.setattr(module, "make_dmc", make)
    orig = JaxLatentModel.init
    monkeypatch.setattr(JaxLatentModel, "init", lambda self, rng, *a: {
        "params": seeded_params(functools.partial(orig, self), *a)})


def evaluate(run_dir):
    """Per-path returns of both CLIs on ``run_dir``'s params.pkl."""
    argv = ["--run_dir", run_dir, "--env_name", "walker-walk", "--n_paths", "1",
            "--image_size", str(HW), "--seed", "3"]
    return final_eval.main(argv + ["--gpu_id", "-1"]), jax_final_eval.main(argv)


def test_port_evaluates_a_jax_snapshot_as_jax_does(tmp_path, short_walker):
    pytest.importorskip("dm_control")
    lm = JaxLatentModel(action_dim=ACT, image_size=HW, **FULL)
    frames, act = jnp.zeros((1, 9, HW, HW, 3)), jnp.zeros((1, 8, ACT))
    latent = {"params": seeded_params(lm.init, frames, act, act[..., :1], act[..., :1],
                                      jnp.zeros(2, jnp.uint32), seed=1)}
    policy = JaxTanhGaussianPolicy((1024, 1024), ACT)
    policy_params = {"params": seeded_params(policy.init, jnp.zeros((1, 8 * 256 + 7 * ACT)),
                                             seed=2)}
    log = JaxLogger()
    log.set_log_dir(str(tmp_path / "jax_run"))
    log.save_itr_params(0, {"latent_params": latent, "policy_params": policy_params})
    log.close()
    got, want = evaluate(str(tmp_path / "jax_run"))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_jax_evaluates_a_port_snapshot_as_the_port_does(tmp_path, short_walker):
    pytest.importorskip("dm_control")
    slac = SlacAlgorithm(ACT, num_sequences=8, buffer_size=10, image_size=HW, seed=4,
                         device="cpu", **FULL)
    trainer = IQLTrainer(TanhGaussianPolicy(slac.feature_action_dim, (1024, 1024), ACT, seed=5),
                         CriticSLAC(slac.z_dim, ACT, (1024, 1024), seed=6), slac_algo=slac,
                         device="cpu")
    log = Logger()
    log.set_log_dir(str(tmp_path / "port_run"))
    log.save_itr_params(0, trainer.get_snapshot())
    log.close()
    got, want = evaluate(str(tmp_path / "port_run"))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=1e-3)
