"""The dataset front end of the port (``cli/collect_dataset.py``,
``cli/image_render.py``) against the JAX package's root scripts.

Both collect on cheetah-run for 30 steps, 25 of them random, at batch 8
(``tests/test_render_collect.py``'s run), on envs of the same task seed
whose action spaces are seeded alike (the scripts leave them unseeded):
the random-action rows are bit-equal and the files have the same keys,
dtypes and shapes (the SAC rows differ: the packages' random streams do).
Both then render that state dataset at 32px with episode boundaries cut
into it, bit-equal; ``add_frame_stacks`` is held on ragged episodes.
Skips where dm_control, h5py or MuJoCo rendering is missing."""

import importlib

import numpy as np
import pytest
import torch

ARGS = ["--env_name", "cheetah-run", "--num_steps", "30", "--start_random_steps", "25",
        "--batch_size", "8", "--log_interval", "0"]
RANDOM_ROWS, ACTION_SEED, IMSIZE = 25, 123, 32
TIMEOUTS = (9, 19)  # episode ends cut into the 30 rows before rendering


def seeded_make_dmc(make_dmc):
    def make(*args, **kw):
        env = make_dmc(*args, **kw)
        env.action_space.seed(ACTION_SEED)
        return env

    return make


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The state and image datasets of both packages (HDF5 contents)."""
    pytest.importorskip("dm_control")
    h5py = pytest.importorskip("h5py")
    import s2p_tpu.envs
    import s2p_tpu_torch.envs

    try:
        s2p_tpu_torch.envs.make_dmc("cheetah-run").render(height=8, width=8)
    except Exception as e:  # noqa: BLE001 (any failure to render means no GL here)
        pytest.skip(f"rendering unavailable: {e}")
    tmp = tmp_path_factory.mktemp("collect_render")

    def read(path):
        with h5py.File(path, "r") as f:
            return {k: f[k][:] for k in f}

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, pkg, module in (("jax", s2p_tpu.envs, "collect_dataset"),
                                  ("torch", s2p_tpu_torch.envs,
                                   "s2p_tpu_torch.cli.collect_dataset")):
            mp.setattr(pkg, "make_dmc", seeded_make_dmc(pkg.make_dmc))
            argv = ARGS + ["--output", str(tmp / f"{name}_state.hdf5")]
            importlib.import_module(module).main(argv + (["--gpu_ids=-1"] if name == "torch"
                                                         else []))
            out[f"{name}_state"] = read(tmp / f"{name}_state.hdf5")
    # both render the JAX state dataset, with episode ends cut into it
    state = dict(out["jax_state"])
    state["timeouts"] = state["timeouts"].copy()
    state["timeouts"][list(TIMEOUTS)] = 1.0
    with h5py.File(tmp / "state.hdf5", "w") as f:
        for k, v in state.items():
            f.create_dataset(k, data=v)
    for name, module in (("jax", "image_render"), ("torch", "s2p_tpu_torch.cli.image_render")):
        importlib.import_module(module).main([
            "--dataset", str(tmp / "state.hdf5"), "--env_name", "cheetah-run",
            "--imsize", str(IMSIZE), "--output", str(tmp / f"{name}_images.hdf5")])
        out[f"{name}_images"] = read(tmp / f"{name}_images.hdf5")
    return out


def test_collected_file_has_the_jax_schema(datasets):
    got, ref = datasets["torch_state"], datasets["jax_state"]
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        assert got[k].dtype == r.dtype and got[k].shape == r.shape, k
    assert ref["observations"].shape == (30, 17) and ref["qpos_qvel"].shape == (30, 18)


@pytest.mark.parametrize("key", ["observations", "actions", "rewards", "next_observations",
                                 "terminals", "timeouts", "qpos_qvel"])
def test_random_action_rows_are_bit_equal(datasets, key):
    got, ref = datasets["torch_state"][key], datasets["jax_state"][key]
    np.testing.assert_array_equal(got[:RANDOM_ROWS], ref[:RANDOM_ROWS])
    if key == "actions":  # then each package's own SAC policy acts
        assert (np.abs(got[RANDOM_ROWS:]) <= 1).all()
        assert not np.array_equal(got[RANDOM_ROWS:], got[RANDOM_ROWS - 5:RANDOM_ROWS])


@pytest.mark.parametrize("key", ["image_observations", "image_observations_tm1",
                                 "image_observations_tm2", "image_observations_tp1"])
def test_rendered_frames_and_stacks_are_bit_equal(datasets, key):
    got, ref = datasets["torch_images"], datasets["jax_images"]
    assert sorted(got) == sorted(ref)
    assert got[key].dtype == np.uint8 and got[key].shape == (30, IMSIZE, IMSIZE, 3)
    np.testing.assert_array_equal(got[key], ref[key])
    frames = got["image_observations"]
    assert (frames[0] != frames[20]).any()  # the cheetah moves
    end = TIMEOUTS[0]
    if key == "image_observations_tp1":  # an episode's last frame repeats itself
        np.testing.assert_array_equal(got[key][end], frames[end])
    if key == "image_observations_tm1":  # and the next one's first does too
        np.testing.assert_array_equal(got[key][end + 1], frames[end + 1])


@pytest.mark.parametrize("timeouts", [[0, 0, 1, 0, 0, 1], [1, 0, 1, 0, 0, 0],
                                      [0, 1, 1, 0, 1, 0], [0, 0, 0, 0, 0, 0]])
def test_add_frame_stacks_matches_jax_on_ragged_episodes(timeouts):
    from image_render import add_frame_stacks as jax_add_frame_stacks

    from s2p_tpu_torch.cli.image_render import add_frame_stacks

    frames = (np.arange(6, dtype=np.uint8).reshape(6, 1, 1, 1) * np.ones((6, 2, 2, 3), np.uint8))
    t = np.asarray(timeouts, np.float32)
    got, ref = add_frame_stacks(frames, t), jax_add_frame_stacks(frames, t)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_render_needs_qpos_qvel(tmp_path):
    h5py = pytest.importorskip("h5py")
    from s2p_tpu_torch.cli.image_render import main

    with h5py.File(tmp_path / "state.hdf5", "w") as f:
        f.create_dataset("timeouts", data=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="qpos_qvel"):
        main(["--dataset", str(tmp_path / "state.hdf5"), "--output", str(tmp_path / "o.hdf5")])


def test_collect_without_cpu_flag_needs_cuda(monkeypatch, tmp_path):
    from s2p_tpu_torch.cli.collect_dataset import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gpu_ids=-1"):
        main(ARGS + ["--output", str(tmp_path / "state.hdf5")])
    assert not list(tmp_path.iterdir())
