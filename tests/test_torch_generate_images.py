"""The port's image bridge (s2p_tpu_torch.cli.generate_images) and both
augmentation CLIs on the CPU (``--gpu_ids=-1``), against the JAX package.

The generator's weights are the seeded numpy params of
test_torch_generator.make_pair, carried into the port; frames are uint8
and may differ by one step where a float lands next to a rounding edge."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.cli.generate_images import generate_images_for_dataset as jax_generate_images
from s2p_tpu.data.hdf5 import load_augment_dataset as jax_load_augment_dataset
from s2p_tpu.data.hdf5 import load_rl_dataset as jax_load_rl_dataset
from s2p_tpu_torch.cli import generate_rl_dataset
from s2p_tpu_torch.cli.generate_images import generate_images_for_dataset
from s2p_tpu_torch.cli.generate_images import main as images_main
from s2p_tpu_torch.cli.state_transition_rollout import main as rollout_main
from s2p_tpu_torch.data.hdf5 import load_augment_dataset, make_synthetic_rl_dataset, save_dataset
from s2p_tpu_torch.gan import S2PGenerator
from s2p_tpu_torch.gan.convert import save_generator_checkpoint
from s2p_tpu_torch.world_model import (
    EnsembleTransition,
    jax_ensemble_params_from_state_dict,
)

from test_torch_generator import STATE_DIM, make_pair

TINY_ENSEMBLE = ["--hidden_features", "16", "--hidden_layers", "2"]


def frames_dataset(n: int, size: int, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    return dict(next_observations=rs.randn(n, STATE_DIM).astype(np.float32),
                image_observations=rs.randint(0, 256, (n, size, size, 3), dtype=np.uint8))


def test_generate_images_matches_jax():
    """N = 10 at batch 4: three batches, the last padded."""
    jgen, params, gen = make_pair(25)
    ds = frames_dataset(10, 25)
    ref = jax_generate_images(ds, jgen, {"params": params}, batch_size=4)
    out = generate_images_for_dataset(ds, gen, batch_size=4)
    assert out.shape == ref.shape == (10, 25, 25, 3) and out.dtype == np.uint8
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.01, (diff.max(), diff.mean())
    # the padded tail renders each row as a full batch would
    np.testing.assert_array_equal(generate_images_for_dataset(ds, gen, batch_size=10), out)


def test_generate_images_bf16_runs_on_a_copy():
    jgen, params, gen = make_pair(25)
    ds = frames_dataset(6, 25, seed=1)
    out = generate_images_for_dataset(ds, gen, batch_size=4, bf16=True)
    assert out.shape == (6, 25, 25, 3) and out.dtype == np.uint8
    assert next(gen.parameters()).dtype == torch.float32  # the caller's module is not cast
    f32 = generate_images_for_dataset(ds, gen, batch_size=4)
    assert np.abs(out.astype(int) - f32.astype(int)).mean() < 8
    jref = jax_generate_images(ds, jgen, {"params": params}, batch_size=4, bf16=True)
    assert np.abs(out.astype(int) - jref.astype(int)).mean() < 8


def _write_dataset(tmp_path, size=16):
    ds = make_synthetic_rl_dataset(n_episodes=2, episode_len=12, obs_dim=STATE_DIM, act_dim=6,
                                   img_hw=size, with_tp1=False)
    path = str(tmp_path / "real.hdf5")
    save_dataset(path, ds)
    return path, ds


def test_clis_end_to_end_on_cpu(tmp_path):
    """Rollout with a fresh ensemble (3 Adam steps), then from a torch state
    dict and from a pickled numpy tree of one ensemble (the same rows from
    both), then the image bridge; JAX's loader reads the result."""
    real, ds = _write_dataset(tmp_path)
    aug = str(tmp_path / "aug.hdf5")
    assert rollout_main(["--dataset", real, "--output", aug, "--gpu_ids=-1", "--train_steps",
                         "3", "--num_sequences", "4", *TINY_ENSEMBLE]) == aug
    fresh = jax_load_augment_dataset(aug)
    assert fresh["actions"].shape == (24, 6) and np.isfinite(fresh["next_observations"]).all()

    model = EnsembleTransition(STATE_DIM, 6, hidden_features=16, hidden_layers=2, seed=5,
                               device="cpu")
    pth, pkl = str(tmp_path / "ens.pth"), str(tmp_path / "ens.pkl")
    torch.save(model.state_dict(), pth)
    with open(pkl, "wb") as f:
        pickle.dump(jax_ensemble_params_from_state_dict(model.state_dict()), f)
    outs = []
    for i, ckpt in enumerate((pth, pkl)):
        path = str(tmp_path / f"aug_{i}.hdf5")
        rollout_main(["--dataset", real, "--output", path, "--gpu_ids=-1", "--model", ckpt,
                      "--num_sequences", "4", *TINY_ENSEMBLE])
        outs.append(load_augment_dataset(path))
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], k)
    assert not np.array_equal(outs[0]["next_observations"], fresh["next_observations"])

    gen = S2PGenerator(STATE_DIM, image_size=16, ngf=8, device="cpu", seed=2)
    save_generator_checkpoint(str(tmp_path / "gen"), gen)
    rl = str(tmp_path / "aug-rl.hdf5")
    assert images_main(["--dataset", aug, "--checkpoint", str(tmp_path / "gen.pth"),
                        "--output", rl, "--ngf", "8", "--batch_size", "16",
                        "--gpu_ids=-1"]) == rl
    back = jax_load_augment_dataset(rl)
    tp1 = back["image_observations_tp1"]
    assert tp1.shape == (24, 16, 16, 3) and tp1.dtype == np.uint8
    np.testing.assert_array_equal(back["next_observations"], fresh["next_observations"])
    expect = generate_images_for_dataset(fresh, gen, batch_size=16)
    np.testing.assert_array_equal(tp1, expect)
    assert set(back) == set(fresh) | {"image_observations_tp1"}
    assert jax_load_rl_dataset(rl)["image_observations_tp1"].shape == tp1.shape
    assert generate_rl_dataset.main is images_main


def test_cli_training_batches_follow_the_seeded_stream(monkeypatch):
    """``train_ensemble`` takes batch min(256, N) of the normalized rows,
    drawn by ``RandomState(seed).randint`` step after step, as the JAX CLI
    does."""
    from s2p_tpu_torch.cli import state_transition_rollout as cli
    from s2p_tpu_torch.world_model import compute_normalization

    ds = make_synthetic_rl_dataset(n_episodes=2, episode_len=12, obs_dim=STATE_DIM, act_dim=6,
                                   img_hw=4)
    norm = compute_normalization(ds)
    x, y = cli.ensemble_training_arrays(ds, norm)
    np.testing.assert_allclose(x[:, :STATE_DIM] * norm["obs_std"] + norm["obs_mean"],
                               ds["observations"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y[:, -1] * norm["reward_std"] + norm["reward_mean"],
                               ds["rewards"], rtol=1e-5, atol=1e-5)
    seen = []

    def recording_step(model, lr=1e-3):
        def step(xb, yb):
            seen.append((xb.numpy().copy(), yb.numpy().copy()))
            return torch.zeros(())
        return step

    monkeypatch.setattr("s2p_tpu_torch.world_model.make_ensemble_train_step", recording_step)
    model = EnsembleTransition(STATE_DIM, 6, hidden_features=16, hidden_layers=2, device="cpu")
    assert cli.train_ensemble(model, ds, norm, steps=3, seed=7) == [(0, 0.0)]
    rs = np.random.RandomState(7)
    for xb, yb in seen:
        idx = rs.randint(0, 24, 24)
        np.testing.assert_array_equal(xb, x[idx])
        np.testing.assert_array_equal(yb, y[idx])
    assert len(seen) == 3


def test_rollout_cli_refuses_a_pickle_of_jax_arrays(tmp_path):
    real, _ = _write_dataset(tmp_path)
    tree = jax_ensemble_params_from_state_dict(EnsembleTransition(
        STATE_DIM, 6, hidden_features=16, hidden_layers=2, device="cpu").state_dict())
    path = str(tmp_path / "jax_arrays.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(jnp.asarray, tree), f)
    with pytest.raises(ValueError, match="device_get"):
        rollout_main(["--dataset", real, "--output", str(tmp_path / "o.hdf5"), "--gpu_ids=-1",
                      "--model", path, *TINY_ENSEMBLE])
    assert not os.path.exists(tmp_path / "o.hdf5")


def test_clis_without_cpu_flag_need_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    absent = str(tmp_path / "absent.hdf5")
    with pytest.raises(RuntimeError, match="gpu_ids=-1"):
        rollout_main(["--dataset", absent])
    with pytest.raises(RuntimeError, match="gpu_ids=-1"):
        images_main(["--dataset", absent, "--checkpoint", absent, "--output", absent])


def test_ensemble_defaults_to_the_card():
    if torch.cuda.is_available():
        model = EnsembleTransition(STATE_DIM, 6, hidden_features=16, hidden_layers=2)
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            EnsembleTransition(STATE_DIM, 6, hidden_features=16, hidden_layers=2)
