"""The port's generation CLI, HDF5 reader and checkpoint loading, against
the JAX package's fixtures and files (CPU: ``--gpu_ids=-1``)."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from s2p_tpu.data.hdf5 import load_rl_dataset as jax_load_rl_dataset
from s2p_tpu.data.hdf5 import make_synthetic_rl_dataset, save_dataset
from s2p_tpu.gan.convert import params_to_state_dict
from s2p_tpu_torch.cli.simple_test import main as gen_main
from s2p_tpu_torch.data.hdf5 import load_rl_dataset
from s2p_tpu_torch.gan import S2PGenerator
from s2p_tpu_torch.gan.convert import (
    diff_state_dict,
    format_diff,
    load_generator_checkpoint,
    remap_state_dict,
    spade_block_name_map,
)

from test_torch_generator import KW, STATE_DIM, inputs, make_pair


@pytest.fixture()
def tiny_hdf5(tmp_path):
    ds = make_synthetic_rl_dataset(n_episodes=2, episode_len=12, obs_dim=17, act_dim=6,
                                   img_hw=16)
    ds["rewards"] = ds["rewards"][:, None]  # [N, 1], as some writers store it
    path = str(tmp_path / "cheetah.hdf5")
    save_dataset(path, ds)
    return path


def test_hdf5_reader_matches_jax(tiny_hdf5):
    ours, ref = load_rl_dataset(tiny_hdf5), jax_load_rl_dataset(tiny_hdf5)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert ours["rewards"].shape == (24,)
    assert len(load_rl_dataset(tiny_hdf5, data_num=5)["observations"]) == 5


@pytest.mark.parametrize("fast", [False, True])
def test_cli_init_random_on_cpu(tiny_hdf5, tmp_path, fast):
    out_dir = gen_main([
        "--dataroot", tiny_hdf5, "--start_idx", "2", "--seq_len", "3", "--ngf", "8",
        "--init_random", "--gpu_ids=-1", "--results_dir", str(tmp_path / "results"),
    ] + (["--fast_inference", "--use_pallas"] if fast else []))
    files = sorted(os.listdir(out_dir))
    assert files == ["gen_00003.png", "gen_00004.png", "gen_00005.png", "real_00002.png",
                     "rollout_00002.png"]
    import imageio.v2 as imageio

    strip = imageio.imread(os.path.join(out_dir, "rollout_00002.png"))
    assert strip.shape == (32, 48, 3)  # generated row over ground-truth row


def test_cli_loads_checkpoint_written_by_jax(tiny_hdf5, tmp_path):
    """A .pkl as the JAX train CLI writes it (numpy params) drives the port's
    CLI on the CPU."""
    from s2p_tpu.gan import S2PGenerator as JaxGenerator
    from test_torch_generator import jax_params

    params = jax_params(JaxGenerator(image_size=16, ngf=8))
    ckpt = str(tmp_path / "cheetah_1.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump({"params": params}, f)
    out_dir = gen_main([
        "--dataroot", tiny_hdf5, "--seq_len", "2", "--ngf", "8", "--checkpoint", ckpt,
        "--gpu_ids", "-1", "--results_dir", str(tmp_path / "results"),
    ])
    assert sum(f.startswith("gen_") for f in os.listdir(out_dir)) == 2


@pytest.mark.parametrize("fmt", ["pth", "pkl", "spade_pth"])
def test_load_generator_checkpoint_matches_jax_apply(tmp_path, fmt):
    """A checkpoint written from JAX params (params_to_state_dict → .pth, the
    train CLI's .pkl, or a SPADE-named .pth) loads strictly into the port
    and gives JAX's pixels."""
    jgen, params, _ = make_pair(64, seed=7)
    path = str(tmp_path / f"ckpt.{fmt.split('_')[-1]}")
    sd = {k: torch.from_numpy(np.array(v)) for k, v in params_to_state_dict(params).items()}
    if fmt == "pkl":
        with open(path, "wb") as f:
            pickle.dump({"params": jax.device_get(params)}, f)
    elif fmt == "spade_pth":
        inv = {v: k for k, v in spade_block_name_map(5).items()}
        sd = {inv.get(k.split(".", 1)[0], k.split(".", 1)[0]) + "." + k.split(".", 1)[1]: v
              for k, v in sd.items()}
        sd = {k.replace(".mlp_shared.", ".mlp_shared.0."): v for k, v in sd.items()}
        assert "G_middle_0.norm_0.mlp_shared.0.weight" in sd
        torch.save({"netG": sd, "epoch": 30}, path)
    else:
        torch.save(sd, path)
    gen = S2PGenerator(STATE_DIM, device="cpu", seed=1, **KW)
    assert load_generator_checkpoint(path, gen) is gen
    s, img = inputs(64, seed=3)
    ref = np.asarray(jax.jit(jgen.apply)({"params": params}, s, img))
    with torch.no_grad():
        out = gen(torch.from_numpy(s), torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_mismatched_checkpoint_raises_with_report(tmp_path):
    gen = S2PGenerator(STATE_DIM, device="cpu", **KW)
    sd = dict(gen.state_dict())
    sd["totally_unknown.weight"] = sd.pop("block_0.conv_0.weight")
    sd["seed_fc.weight"] = sd["seed_fc.weight"][:, :4]
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="missing +block_0.conv_0.weight"):
        load_generator_checkpoint(path, gen)
    rep = diff_state_dict(sd, gen.state_dict())
    assert not rep["ok"] and "totally_unknown.weight" in rep["unexpected"]
    assert any(k == "seed_fc.weight" for k, _, _ in rep["shape_mismatch"])
    assert "shape" in format_diff(rep)


def test_remap_state_dict_prefix_boundaries():
    sd = {"up_0.conv_0.weight": 1, "up_01.conv_0.weight": 2, "up_0": 3}
    out = remap_state_dict(sd, {"up_0": "block_3"}, substitutions=())
    assert out == {"block_3.conv_0.weight": 1, "up_01.conv_0.weight": 2, "block_3": 3}
    assert "up_01.conv_0.weight" not in remap_state_dict(sd, {"up_01": ""}, substitutions=())
