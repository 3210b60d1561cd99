"""``python -m s2p_tpu_torch.cli.slac_pretrain`` on the CPU: a tiny HDF5
fixture in, a ``latent.pkl`` out that the JAX package loads and that gives
the port's features (1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2p_tpu.slac import LatentModel as JaxLatentModel
from s2p_tpu_torch.cli.slac_pretrain import main
from s2p_tpu_torch.data.hdf5 import make_synthetic_rl_dataset, save_dataset
from s2p_tpu_torch.slac import SlacAlgorithm
from tests.test_torch_slac import ACT, make_jax_slac

WIDTHS = dict(feature_dim=16, z1_dim=4, z2_dim=8)


def test_cli_writes_a_latent_the_jax_package_loads(tmp_path, capsys):
    path = tmp_path / "tiny.hdf5"
    save_dataset(str(path), make_synthetic_rl_dataset(2, 12, act_dim=ACT, img_hw=64))
    out = tmp_path / "model"
    argv = ["--gpu_ids=-1", "--dataset", str(path), "--num_steps", "2", "--batch_size", "2",
            "--num_sequences", "3", "--save_dir", str(out), "--scan_chunk", "1",
            "--log_every", "1"] + [f"--{k}={v}" for k, v in WIDTHS.items()]
    assert main(argv) == str(out)
    log = capsys.readouterr().out
    assert "buffer: 19 sequence windows" in log  # 10 + 9: the final timeout row dropped and "latent step 2/2" in log
    assert (out / "latent.pkl").exists() and (out / "encoder.pkl").exists()

    jslac = make_jax_slac(hidden_units=(256, 256), **WIDTHS)
    jslac.load_latent(str(out / "latent.pkl"))
    port = SlacAlgorithm(ACT, num_sequences=3, image_size=64, device="cpu", **WIDTHS)
    port.load_latent(str(out / "latent.pkl"))
    obs = np.random.RandomState(0).rand(2, 4, 64, 64, 3).astype(np.float32)
    ref = jslac.latent.apply(jslac.params, jnp.asarray(obs), method=JaxLatentModel.encode)
    with torch.no_grad():
        got = port.latent.encode(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    fresh = SlacAlgorithm(ACT, num_sequences=3, image_size=64, device="cpu", **WIDTHS)
    assert not torch.equal(fresh.latent.encoder.net[0].weight, port.latent.encoder.net[0].weight)


def test_cli_without_the_cpu_flag_needs_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gpu_ids=-1"):
        main(["--dataset", str(tmp_path / "absent.hdf5")])
