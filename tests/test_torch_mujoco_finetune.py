"""``python -m s2p_tpu_torch.cli.mujoco_finetune`` on the CPU (``--gpu_id -1
--debug``): the seeded tiny walker image-IQL run of
``tests/test_csv_regression.py::run_tiny_walker_image`` (the same datasets,
64px, a seeded ngf-8 generator rendering the augment frames on the device,
``--no_video``), CQL, the state branch and ``--resume_dir``.

The port's progress.csv has exactly the JAX fixture's columns (the
frozen-key contract). Its values are held to the port's own committed
fixture, ``tests/fixtures/torch_walker_image_iql_progress.csv``, at
``rel_tol`` 1e-5 on every column but the ``time/`` ones: the port draws its
random numbers from ``torch.Generator``s, not from JAX's keys, so JAX's
values cannot be the reference. The run fixes torch's thread count (and
restores it), so the values do not depend on how many workers share the
machine. Regenerate the fixture after an intended change of behaviour with

    python tests/test_torch_mujoco_finetune.py --regen
"""

import csv
import os
import os.path as osp
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("dm_control")

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
if REPO not in sys.path:  # for --regen
    sys.path.insert(0, REPO)

from s2p_tpu_torch.cli.mujoco_finetune import main  # noqa: E402
from s2p_tpu_torch.data.hdf5 import (  # noqa: E402
    make_slac_window_indices,
    make_synthetic_rl_dataset,
    save_dataset,
)
from s2p_tpu_torch.gan import S2PGenerator  # noqa: E402
from s2p_tpu_torch.gan.convert import save_generator_checkpoint  # noqa: E402
from s2p_tpu_torch.testing import check_equal, get_exp  # noqa: E402

FIXTURES = osp.join(osp.dirname(osp.abspath(__file__)), "fixtures")
FIXTURE = osp.join(FIXTURES, "torch_walker_image_iql_progress.csv")
JAX_FIXTURE = osp.join(FIXTURES, "walker_image_iql_progress.csv")
OBS, ACT, HW, EP_LEN = 24, 6, 64, 12  # walker-walk
THREADS = 4


def write_inputs(tmp_path) -> dict:
    """The real and augment HDF5s of the JAX regression (seed 3) and a
    seeded ngf-8 generator checkpoint; returns their paths."""
    real = make_synthetic_rl_dataset(n_episodes=2, episode_len=EP_LEN, obs_dim=OBS, act_dim=ACT,
                                     img_hw=HW, seed=3)
    paths = dict(real=str(tmp_path / "real.hdf5"), aug=str(tmp_path / "aug.hdf5"),
                 gen=str(tmp_path / "g"))
    save_dataset(paths["real"], real)
    n = len(real["timeouts"])
    obs_i, act_i = zip(*(make_slac_window_indices(EP_LEN, start, 8) for start in (0, EP_LEN)))
    aug = dict(real, original_actions=real["actions"], original_rewards=real["rewards"],
               slac_observation_indices=np.concatenate(obs_i),
               slac_action_indices=np.concatenate(act_i),
               aleatoric_uncertainty=np.full((n, 1), 0.5, np.float32),
               disagreement_uncertainty=np.full((n, 1), 0.25, np.float32))
    aug.pop("image_observations_tp1")  # the frames come from the generator
    save_dataset(paths["aug"], aug)
    save_generator_checkpoint(paths["gen"], S2PGenerator(OBS, image_size=HW, ngf=8, seed=5,
                                                         device="cpu"))
    return paths


def run_cli(tmp_path, *args) -> str:
    """The CLI at a fixed thread count (restored after); returns its log dir."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        return main(["--env_name", "walker-walk", "--gpu_id", "-1", "--no_video",
                     "--log_dir", str(tmp_path / "logs"), *args])
    finally:
        torch.set_num_threads(threads)


def run_tiny_walker_image(tmp_path) -> str:
    p = write_inputs(tmp_path)
    return run_cli(tmp_path, "--exp_name", "walker_csv_reg", "--algo_type", "iql", "--image_rl",
                   "--slac_representation", "--data_path_real", p["real"],
                   "--data_path_gen", p["aug"], "--gan_checkpoint", p["gen"] + ".pth",
                   "--gan_ngf", "8", "--uncertainty_type", "aleatoric",
                   "--uncertainty_penalty_lambda", "2", "--image_size", str(HW), "--debug",
                   "--seed", "11")


def header(path: str) -> list:
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_walker_image_iql_matches_the_fixtures(tmp_path):
    log_dir = run_tiny_walker_image(tmp_path)
    got = get_exp(osp.join(log_dir, "progress.csv"))
    assert set(header(osp.join(log_dir, "progress.csv"))) == set(header(JAX_FIXTURE))
    want = get_exp(FIXTURE)
    assert [r["epoch"] for r in got] == ["-2", "-1", "0"]
    keys = [k for k in want[0] if not k.startswith("time/")]
    check_equal(want, got, keys, rel_tol=1e-5)
    with open(osp.join(log_dir, "debug.log")) as f:
        assert "synthesized 24 next-frames on device" in f.read()
    for name in ("params.pkl", "itr_0.pkl", "rewards_list.pkl", "variant.json"):
        assert osp.exists(osp.join(log_dir, name)), name
    with open(osp.join(log_dir, "params.pkl"), "rb") as f:
        snap = pickle.load(f)
    assert {"policy_params", "critic_params", "latent_params"} <= set(snap)
    assert isinstance(snap["policy_params"]["params"]["fc0"]["kernel"], np.ndarray)


def test_walker_image_cql_runs(tmp_path):
    """run_cql_image.sh's trainer, each train loop as one train_many call."""
    p = write_inputs(tmp_path)
    log_dir = run_cli(tmp_path, "--exp_name", "walker_cql", "--algo_type", "cql", "--image_rl",
                      "--slac_representation", "--data_path_real", p["real"],
                      "--image_size", str(HW), "--debug", "--scan_training")
    rows = get_exp(osp.join(log_dir, "progress.csv"))
    assert [r["epoch"] for r in rows] == ["-2", "-1", "0"]
    trainer = {k: float(v) for k, v in rows[-1].items() if k.startswith("trainer/")}
    assert {"trainer/min_qf1_loss", "trainer/alpha", "trainer/loss_kld"} <= set(trainer)
    assert trainer["trainer/num train calls"] == 6.0
    assert all(np.isfinite(v) for v in trainer.values())
    assert float(rows[-1]["replay_buffer/real_size"]) == float(rows[-1]["replay_buffer/size"])


def write_state_dataset(tmp_path) -> str:
    path = str(tmp_path / "state.hdf5")
    save_dataset(path, make_synthetic_rl_dataset(n_episodes=2, episode_len=EP_LEN, obs_dim=OBS,
                                                 act_dim=ACT, img_hw=8, seed=4, with_tp1=False))
    return path


def test_state_branch_cql(tmp_path):
    log_dir = run_cli(tmp_path, "--exp_name", "walker_state", "--algo_type", "cql",
                      "--data_path_real", write_state_dataset(tmp_path), "--debug")
    rows = get_exp(osp.join(log_dir, "progress.csv"))
    assert [r["epoch"] for r in rows] == ["-2", "-1", "0"]
    # offline epochs leave the buffer alone; the online epoch adds its 10 steps
    assert [float(r["replay_buffer/size"]) for r in rows] == [24.0, 24.0, 34.0]
    assert all(np.isfinite(float(v)) for k, v in rows[-1].items() if k.startswith("trainer/"))


def test_resume_dir_advances_the_start_epoch(tmp_path):
    """A run of epochs −2 and −1 checkpoints every epoch; a second run with
    the same --resume_dir restores 4 train steps, starts at epoch 0 and
    counts on from them."""
    common = ["--algo_type", "iql", "--data_path_real", write_state_dataset(tmp_path),
              "--start_epoch", "-2", "--num_trains_per_train_loop", "2", "--batch_size", "8",
              "--max_path_length", "10", "--resume_dir", str(tmp_path / "ck")]
    first = run_cli(tmp_path, "--exp_name", "first", "--num_epochs", "0", *common)
    assert [r["epoch"] for r in get_exp(osp.join(first, "progress.csv"))] == ["-2", "-1"]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2.pt", "step_4.pt"]
    second = run_cli(tmp_path, "--exp_name", "second", "--num_epochs", "1", *common)
    rows = get_exp(osp.join(second, "progress.csv"))
    assert [r["epoch"] for r in rows] == ["0"]
    assert float(rows[0]["trainer/num train calls"]) == 6.0
    with open(osp.join(second, "debug.log")) as f:
        assert "at 4 train steps → epoch 0" in f.read()


if __name__ == "__main__":
    import tempfile

    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_mujoco_finetune.py --regen")
    import pathlib

    with tempfile.TemporaryDirectory() as td:
        log_dir = run_tiny_walker_image(pathlib.Path(td))
        shutil.copy(osp.join(log_dir, "progress.csv"), FIXTURE)
    print(f"fixture written: {FIXTURE}")
