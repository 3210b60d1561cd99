"""The port's training CLI on the CPU (``--gpu_ids=-1``, tiny widths) on
the HDF5 fixture of test_torch_cli.py, its pair dataset against the JAX
package's, and its checkpoints loaded by the JAX package."""

import csv
import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from s2p_tpu.data.pair_dataset import S2PPairDataset as JaxPairDataset
from s2p_tpu.gan import S2PGenerator as JaxGenerator
from s2p_tpu.gan.convert import load_generator_checkpoint as jax_load_generator_checkpoint
from s2p_tpu_torch.cli.train_gan import main as train_main
from s2p_tpu_torch.data.pair_dataset import S2PPairDataset
from s2p_tpu_torch.gan import S2PGenerator
from s2p_tpu_torch.gan.convert import load_generator_checkpoint
from s2p_tpu_torch.utils.checkpoint import CheckpointManager

from test_torch_cli import tiny_hdf5  # noqa: F401  (the fixture)
from test_torch_generator import STATE_DIM, inputs

TINY = ["--ngf", "8", "--ndf", "8", "--num_D", "2", "--n_layers_D", "2", "--eval_num", "8",
        "--gpu_ids=-1"]


def run(tmp_path, dataroot, *extra, name="run"):
    log_dir = train_main(["--dataroot", dataroot, *TINY,
                          "--checkpoints_dir", str(tmp_path / "ckpt"),
                          "--log_dir", str(tmp_path / f"logs_{name}"), *extra])
    with open(os.path.join(log_dir, "progress.csv")) as f:
        return list(csv.DictReader(f))


def test_pair_dataset_matches_jax(tiny_hdf5):
    ours, ref = S2PPairDataset.from_hdf5(tiny_hdf5), JaxPairDataset.from_hdf5(tiny_hdf5)
    for k in ("prev_images", "states", "target_images", "env_ids"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    multi = S2PPairDataset.from_hdf5(f"{tiny_hdf5},{tiny_hdf5}")
    jmulti = JaxPairDataset.from_hdf5(f"{tiny_hdf5},{tiny_hdf5}")
    assert multi.n_envs == 2 and len(multi.env_subset(1, 5)) == 5
    np.testing.assert_array_equal(multi.env_ids, jmulti.env_ids)
    rows = {k: np.asarray(v)[:-1] for k, v in {
        "image_observations": ref.prev_images, "next_observations": ref.states}.items()}
    rows["timeouts"] = np.array([0, 1, 0] + [0] * (len(ref) - 4), np.float32)
    pairs, jpairs = S2PPairDataset.from_dataset(rows), JaxPairDataset.from_dataset(rows)
    np.testing.assert_array_equal(pairs.prev_images, jpairs.prev_images)  # episode boundary
    assert len(pairs) == len(rows["timeouts"]) - 2
    b1 = list(pairs.batches(4, np.random.RandomState(0)))
    b2 = list(jpairs.batches(4, np.random.RandomState(0)))
    assert len(b1) == len(b2) and all(np.array_equal(x["state"], y["state"])
                                      for x, y in zip(b1, b2))


def test_train_cli_on_cpu_checkpoints_load_in_jax(tiny_hdf5, tmp_path):
    rows = run(tmp_path, tiny_hdf5, "--niter", "2", "--max_steps", "2")
    assert [r["epoch"] for r in rows] == ["1", "2"]
    for key in ("d_loss", "g_loss", "g_vgg", "d_r1", "eval/psnr", "eval/ssim",
                "eval/best_psnr"):
        assert np.isfinite(float(rows[-1][key])), key
    ckpt = tmp_path / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["cheetah_2.pkl", "cheetah_2.pth", "cheetah_best.pkl",
                                        "cheetah_best.pth"]

    gen = S2PGenerator(STATE_DIM, image_size=16, ngf=8, device="cpu")
    load_generator_checkpoint(str(ckpt / "cheetah_2.pth"), gen)
    s, img = inputs(16, seed=2)
    with torch.no_grad():
        out = gen(torch.from_numpy(s), torch.from_numpy(img)).numpy()
    jgen = JaxGenerator(image_size=16, ngf=8)
    # JAX's loader reads only ``generator.init`` (for the .pth template);
    # jitted, since flax's op-by-op init is slow on the CPU
    template = SimpleNamespace(init=jax.jit(jgen.init))
    for path in ("cheetah_2.pkl", "cheetah_2.pth"):
        params = jax_load_generator_checkpoint(str(ckpt / path), template, s[:1], img[:1])
        ref = np.asarray(jax.jit(jgen.apply)(params, s, img))
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4, err_msg=path)


def test_train_cli_resumes_and_runs_scanned_chunks(tiny_hdf5, tmp_path):
    resume = ["--resume_dir", str(tmp_path / "resume"), "--no_vgg_loss"]
    first = run(tmp_path, tiny_hdf5, "--niter", "1", *resume, name="a")
    assert [r["epoch"] for r in first] == ["1"]
    mgr = CheckpointManager(str(tmp_path / "resume"))
    assert mgr.latest_step() == 1
    state = mgr.restore()
    assert (state["g_step"], state["d_step"]) == (1, 1) and state["best"][1] == 1.0

    second = run(tmp_path, tiny_hdf5, "--niter", "3", "--scan_chunk", "2", *resume, name="b")
    assert [r["epoch"] for r in second] == ["2", "3"]
    assert mgr.steps() == [2, 3]  # max_to_keep=2
    state = mgr.restore()
    assert state["g_step"] == 3 and np.isfinite(float(second[-1]["g_loss"]))


def test_train_cli_without_cpu_flag_needs_cuda(monkeypatch, tiny_hdf5, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gpu_ids=-1"):
        train_main(["--dataroot", tiny_hdf5, "--log_dir", str(tmp_path / "logs")])
    assert not glob.glob(str(tmp_path / "logs" / "*"))
