"""The port's training CLI under ``torch.distributed.run``: 2 ranks on the
CPU (``--gpu_ids -1``, gloo) on a cheetah + walker pair dataset (states
17 and 24 wide, zero-padded to 24), the scanned data-parallel path
(``train_many_dp``) and then the per-step path resumed from it."""

import csv
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from s2p_tpu_torch.data.hdf5 import make_synthetic_rl_dataset, save_dataset
from s2p_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--ngf", "8", "--ndf", "8", "--num_D", "1", "--n_layers_D", "2", "--eval_num", "8",
        "--no_vgg_loss", "--batchSize", "4", "--gpu_ids", "-1"]


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """cheetah: 2 episodes of 12 pairs; walker: 1 of 9; 33 pairs, so one
    trailing row is dropped for 2 ranks."""
    tmp = tmp_path_factory.mktemp("dp_cli")
    paths = []
    for name, episodes, length, obs in (("cheetah", 2, 12, 17), ("walker", 1, 9, 24)):
        path = str(tmp / f"{name}.hdf5")
        save_dataset(path, make_synthetic_rl_dataset(n_episodes=episodes, episode_len=length,
                                                     obs_dim=obs, act_dim=6, img_hw=16,
                                                     seed=len(paths)))
        paths.append(path)
    return tmp, ",".join(paths)


def torchrun(tmp, dataroot, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "s2p_tpu_torch.cli.train_gan", "--dataroot", dataroot, *TINY,
           "--checkpoints_dir", str(tmp / "ckpt"), "--log_dir", str(tmp / "logs"),
           "--resume_dir", str(tmp / "resume"), *extra]
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    return out


def checksums(out):
    """rank → (start epoch, state checksum), from each rank's line."""
    found = re.findall(r"rank (\d) of 2 on cpu: start epoch (\d+), steps \S+, state checksum "
                       r"(-?\d+)", out)
    return {int(r): (int(e), int(c)) for r, e, c in found}


@pytest.fixture(scope="module")
def runs(dataroot):
    tmp, root = dataroot
    scanned = torchrun(tmp, root, "--niter", "2", "--max_steps", "2", "--scan_chunk", "2")
    per_step = torchrun(tmp, root, "--niter", "2", "--max_steps", "2")
    return tmp, scanned, per_step


def test_both_ranks_train_and_only_rank_0_writes(runs):
    tmp, scanned, per_step = runs
    for out in (scanned, per_step):
        assert "backend gloo" in out and sorted(checksums(out)) == [0, 1]
    assert "DP sharding: dropped 1 trailing row(s) to make the dataset divide over 2 devices " \
           "(32 rows kept)" in scanned
    assert "sharded over 2 devices" in scanned
    # one run dir per launch (rank 0's), each with one progress row per epoch
    runs_dirs = sorted(glob.glob(str(tmp / "logs" / "*" / "*")))
    assert len(runs_dirs) == 2
    rows = []
    for d in runs_dirs:
        with open(os.path.join(d, "progress.csv")) as f:
            rows.append(list(csv.DictReader(f)))
    assert [[r["epoch"] for r in rs] for rs in rows] == [["1"], ["2"]]
    for rs in rows:
        for key in ("d_loss", "g_loss", "d_r1", "eval/psnr", "eval/psnr_env1"):
            assert np.isfinite(float(rs[-1][key])), key
    assert sorted(os.listdir(tmp / "ckpt")) == ["cheetah_2.pkl", "cheetah_2.pth",
                                                "cheetah_best.pkl", "cheetah_best.pth"]
    assert sorted(os.listdir(tmp / "resume")) == ["step_1.pt", "step_2.pt"]
    assert per_step.count("saved checkpoint") == 2 and scanned.count("saved checkpoint") == 1


def test_resume_restores_the_same_state_on_both_ranks(runs):
    tmp, scanned, per_step = runs
    started, resumed = checksums(scanned), checksums(per_step)
    assert started[0] == started[1] and started[0][0] == 1
    assert resumed[0] == resumed[1] and resumed[0][0] == 2
    state = CheckpointManager(str(tmp / "resume")).restore()
    assert (state["g_step"], state["d_step"]) == (4, 4)
