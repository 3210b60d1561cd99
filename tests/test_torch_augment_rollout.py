"""The port's augment rollouts (s2p_tpu_torch.world_model.rollout) and its
HDF5 IO (s2p_tpu_torch.data.hdf5) against the JAX package's, on the CPU.

Both packages draw their random numbers on the host from one
``np.random.RandomState(seed)`` in the same order, so with the same seeded
weights (test_torch_world_model.make_pair) actions, members, SLAC window
indices and sentinel rows are bit-equal; predicted floats agree to 1e-5."""

import numpy as np
import pytest
import torch

from s2p_tpu.data import hdf5 as jax_hdf5
from s2p_tpu.world_model import compute_normalization as jax_compute_normalization
from s2p_tpu.world_model import generate_augmented_dataset as jax_generate_augmented
from s2p_tpu.world_model.rollout import _predict as jax_predict
from s2p_tpu.world_model.rollout import generate_multistep_dataset as jax_generate_multistep
from s2p_tpu_torch.data import hdf5
from s2p_tpu_torch.world_model import (
    compute_normalization,
    generate_augmented_dataset,
    generate_multistep_dataset,
)
from s2p_tpu_torch.world_model.rollout import _predict

from test_torch_world_model import ACT, E, OBS, make_pair

EXACT = ("observations", "actions", "timeouts", "terminals", "image_observations",
         "image_observations_tp1", "original_actions", "original_rewards",
         "slac_observation_indices", "slac_action_indices")
LOW, HIGH = np.full(ACT, -1.0), np.full(ACT, 1.0)


def dataset(n_episodes=2, episode_len=12):
    return hdf5.make_synthetic_rl_dataset(n_episodes=n_episodes, episode_len=episode_len,
                                          obs_dim=OBS, act_dim=ACT, img_hw=8)


def assert_same_dataset(ours: dict, ref: dict, exact=EXACT):
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        if k in exact:
            np.testing.assert_array_equal(ours[k], v, k)
        else:
            np.testing.assert_allclose(ours[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_synthetic_dataset_windows_and_episodes_match_jax():
    ours = dataset()
    ref = jax_hdf5.make_synthetic_rl_dataset(n_episodes=2, episode_len=12, obs_dim=OBS,
                                             act_dim=ACT, img_hw=8)
    assert_same_dataset(ours, ref, exact=tuple(ref))
    assert hdf5.SENTINEL == jax_hdf5.SENTINEL
    for length, start, seq in ((12, 0, 4), (20, 12, 8), (9, 3, 8)):
        for a, b in zip(hdf5.make_slac_window_indices(length, start, seq),
                        jax_hdf5.make_slac_window_indices(length, start, seq)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="num_sequences"):
        hdf5.make_slac_window_indices(8, 0, 8)
    timeouts = np.array([0, 0, 1, 0, 1, 0, 0], np.float32)
    assert hdf5.episode_slices(timeouts) == jax_hdf5.episode_slices(timeouts)


def test_compute_normalization_matches_jax():
    ds = dataset()
    ours, ref = compute_normalization(ds), jax_compute_normalization(ds)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], k)
        assert ours[k].dtype == np.float32


def test_predict_matches_jax():
    """One random member per row; disagreement on μ[..., :-1], aleatoric on
    the whole σ."""
    jmodel, params, model = make_pair()
    rs = np.random.RandomState(4)
    obs = rs.randn(9, OBS).astype(np.float32)
    act = rs.uniform(-1, 1, (9, ACT)).astype(np.float32)
    member = rs.randint(0, E, 9)
    ref = jax_predict(jmodel, params, obs, act, member)
    ours = _predict(model, *(torch.from_numpy(a) for a in (obs, act, member)))
    for name, a, b in zip(("sel_obs", "sel_rew", "disagreement", "aleatoric"), ours, ref):
        assert tuple(a.shape) == np.asarray(b).shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("chunk", [65536, 7])
def test_augmented_dataset_matches_jax(chunk):
    jmodel, params, model = make_pair()
    ds = dataset()
    norm = compute_normalization(ds)
    ref = jax_generate_augmented(ds, jmodel, params, norm, LOW, HIGH, num_sequences=4, seed=3)
    ours = generate_augmented_dataset(ds, model, norm, LOW, HIGH, num_sequences=4, seed=3,
                                      chunk=chunk)
    assert_same_dataset(ours, ref)
    rs = np.random.RandomState(3)  # the order both packages draw in: actions, then members
    np.testing.assert_array_equal(
        ours["actions"], rs.uniform(LOW, HIGH, (len(ds["actions"]), ACT)).astype(np.float32))
    assert (ours["slac_observation_indices"][:4] == hdf5.SENTINEL).all()
    assert (ours["slac_action_indices"][12:16] == hdf5.SENTINEL).all()
    np.testing.assert_array_equal(ours["slac_observation_indices"][16], np.arange(12, 17))
    assert (ours["aleatoric_uncertainty"] > 0).all()


def test_augmented_dataset_rejects_terminal_rows():
    _, _, model = make_pair()
    ds = dataset()
    ds["terminals"][5] = 1.0
    with pytest.raises(ValueError, match="terminal"):
        generate_augmented_dataset(ds, model, compute_normalization(ds), LOW, HIGH)


@pytest.mark.parametrize("policy", [False, True])
def test_multistep_dataset_matches_jax(policy):
    """Trajectory-major rows, timeouts on each rollout's last row, starting
    frames repeated; with ``action_fn`` the actions come from the policy
    and the starts and members still from the seeded stream."""
    jmodel, params, model = make_pair(seed=2)
    ds = dataset()
    norm = compute_normalization(ds)
    action_fn = (lambda obs: np.tanh(obs[:, :ACT])) if policy else None
    ref = jax_generate_multistep(ds, jmodel, params, norm, LOW, HIGH, horizon=3, n_starts=5,
                                 action_fn=action_fn, seed=1)
    ours = generate_multistep_dataset(ds, model, norm, LOW, HIGH, horizon=3, n_starts=5,
                                      action_fn=action_fn, seed=1)
    # a policy's actions after the first step follow the predicted states
    exact = ("timeouts", "image_observations") + (() if policy else ("actions",))
    assert_same_dataset(ours, ref, exact=exact)
    assert ours["observations"].shape == (15, OBS)
    assert (ours["timeouts"][2::3] == 1).all() and ours["timeouts"].sum() == 5
    np.testing.assert_allclose(ours["observations"][1], ours["next_observations"][0], rtol=1e-6)
    if policy:
        np.testing.assert_allclose(ours["actions"][0], np.tanh(ours["observations"][0, :ACT]),
                                   rtol=1e-6)


def test_hdf5_round_trips_both_ways(tmp_path):
    """The port writes and JAX's ``load_augment_dataset`` reads; JAX writes
    and the port's loaders read (2-D rewards squeezed, as JAX's are)."""
    _, _, model = make_pair()
    ds = dataset()
    aug = generate_augmented_dataset(ds, model, compute_normalization(ds), LOW, HIGH,
                                     num_sequences=4)
    aug["original_rewards"] = aug["original_rewards"][:, None]
    ours_path, ref_path = str(tmp_path / "ours.hdf5"), str(tmp_path / "ref.hdf5")
    hdf5.save_dataset(ours_path, aug)
    jax_hdf5.save_dataset(ref_path, aug)
    for loader, path in ((jax_hdf5.load_augment_dataset, ours_path),
                         (hdf5.load_augment_dataset, ref_path)):
        back = loader(path)
        assert back["original_rewards"].shape == (len(ds["rewards"]),)
        assert sorted(back) == sorted(jax_hdf5.load_augment_dataset(ref_path))
        for k, v in back.items():
            np.testing.assert_array_equal(v, np.asarray(aug[k]).reshape(v.shape), k)
    five = hdf5.load_augment_dataset(ours_path, data_num=5)
    assert all(len(v) == 5 for v in five.values())
    for ours, ref in ((hdf5.load_state_dataset, jax_hdf5.load_state_dataset),
                      (hdf5.load_rl_dataset, jax_hdf5.load_rl_dataset)):
        a, b = ours(ref_path), ref(ref_path)
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in b)
    del aug["slac_action_indices"]
    hdf5.save_dataset(ours_path, aug)
    with pytest.raises(KeyError, match="slac_action_indices"):
        hdf5.load_augment_dataset(ours_path)
