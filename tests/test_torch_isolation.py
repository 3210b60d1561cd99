"""The port stands alone: no module of s2p_tpu_torch, and not chip_smoke.py,
imports JAX, flax or the JAX package; its entry points run on the card
unless the caller asks for the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import s2p_tpu_torch
names = [m.name for m in pkgutil.walk_packages(s2p_tpu_torch.__path__, "s2p_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "s2p_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert {"s2p_tpu_torch.gan.cuda_kernels", "s2p_tpu_torch.gan.generator",
            "s2p_tpu_torch.gan.fast_inference", "s2p_tpu_torch.gan.convert",
            "s2p_tpu_torch.gan.rollout", "s2p_tpu_torch.data.hdf5",
            "s2p_tpu_torch.cli.simple_test", "s2p_tpu_torch.gan.discriminator",
            "s2p_tpu_torch.gan.losses", "s2p_tpu_torch.gan.perceptual",
            "s2p_tpu_torch.gan.training", "s2p_tpu_torch.gan.metrics",
            "s2p_tpu_torch.data.pair_dataset", "s2p_tpu_torch.utils.logging",
            "s2p_tpu_torch.utils.checkpoint", "s2p_tpu_torch.utils.seeding",
            "s2p_tpu_torch.cli.train_gan", "s2p_tpu_torch.world_model",
            "s2p_tpu_torch.world_model.ensemble", "s2p_tpu_torch.world_model.rollout",
            "s2p_tpu_torch.cli.state_transition_rollout", "s2p_tpu_torch.cli.generate_images",
            "s2p_tpu_torch.cli.generate_rl_dataset", "s2p_tpu_torch.nn",
            "s2p_tpu_torch.nn.initializers", "s2p_tpu_torch.nn.distributions",
            "s2p_tpu_torch.nn.mlp", "s2p_tpu_torch.nn.cnn", "s2p_tpu_torch.nn.convert",
            "s2p_tpu_torch.slac", "s2p_tpu_torch.slac.latent", "s2p_tpu_torch.slac.convert",
            "s2p_tpu_torch.slac.algo", "s2p_tpu_torch.slac.pretrain",
            "s2p_tpu_torch.data.replay", "s2p_tpu_torch.rl", "s2p_tpu_torch.rl.critics",
            "s2p_tpu_torch.rl.policies", "s2p_tpu_torch.rl.scan_utils", "s2p_tpu_torch.rl.iql",
            "s2p_tpu_torch.cli.slac_pretrain", "s2p_tpu_torch.rl.state", "s2p_tpu_torch.rl.sac",
            "s2p_tpu_torch.rl.cql", "s2p_tpu_torch.slac.networks", "s2p_tpu_torch.core",
            "s2p_tpu_torch.core.trainer", "s2p_tpu_torch.core.simple_offline_rl_algorithm",
            "s2p_tpu_torch.utils.timer", "s2p_tpu_torch.gan.inception",
            "s2p_tpu_torch.utils.stats", "s2p_tpu_torch.utils.config", "s2p_tpu_torch.testing",
            "s2p_tpu_torch.testing.csv_util", "s2p_tpu_torch.testing.stubs",
            "s2p_tpu_torch.envs", "s2p_tpu_torch.envs.wrappers", "s2p_tpu_torch.envs.dmc",
            "s2p_tpu_torch.samplers", "s2p_tpu_torch.samplers.agents",
            "s2p_tpu_torch.samplers.rollout", "s2p_tpu_torch.samplers.path_collector",
            "s2p_tpu_torch.samplers.step_collector", "s2p_tpu_torch.core.batch_rl_algorithm",
            "s2p_tpu_torch.core.online_rl_algorithm", "s2p_tpu_torch.core.video",
            "s2p_tpu_torch.data.env_replay_buffer", "s2p_tpu_torch.data.path_loaders",
            "s2p_tpu_torch.cli.mujoco_finetune", "s2p_tpu_torch.cli.final_eval",
            "s2p_tpu_torch.parallel", "s2p_tpu_torch.parallel.mesh",
            "s2p_tpu_torch.parallel.distributed", "s2p_tpu_torch.utils.profiling",
            "s2p_tpu_torch.utils.launcher", "s2p_tpu_torch.utils.sweep",
            "s2p_tpu_torch.utils.plotting", "s2p_tpu_torch.utils.pyutil",
            "s2p_tpu_torch.utils.io", "s2p_tpu_torch.utils.exploration",
            "s2p_tpu_torch.testing.debug_util", "s2p_tpu_torch.testing.gan_dp_worker",
            "s2p_tpu_torch.testing.tp_worker", "s2p_tpu_torch.nn.augmentations",
            "s2p_tpu_torch.rl.encoders", "s2p_tpu_torch.nn.misc_nets",
            "s2p_tpu_torch.data.loaders", "s2p_tpu_torch.data.her_buffer",
            "s2p_tpu_torch.data.multitask_buffer", "s2p_tpu_torch.envs.stacks",
            "s2p_tpu_torch.envs.extra_wrappers", "s2p_tpu_torch.envs.image_env",
            "s2p_tpu_torch.envs.multitask", "s2p_tpu_torch.samplers.extra_collectors",
            "s2p_tpu_torch.testing.goal_env"
            } <= set(report["modules"])


def test_cli_without_cpu_flag_needs_cuda(monkeypatch, tmp_path):
    from s2p_tpu_torch.cli.simple_test import main, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gpu_ids=-1"):
        main(["--dataroot", str(tmp_path / "absent.hdf5"), "--init_random"])
    with pytest.raises(RuntimeError, match="not available"):
        resolve_device("0,1")
    assert resolve_device("-1") == torch.device("cpu")


@pytest.mark.parametrize("cli", ["mujoco_finetune", "final_eval"])
def test_rl_clis_without_cpu_flag_need_cuda(monkeypatch, tmp_path, cli):
    import importlib

    main = importlib.import_module(f"s2p_tpu_torch.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gpu_id=-1"):
        main(["--log_dir", str(tmp_path)] if cli == "mujoco_finetune"
             else ["--run_dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # refused before any file was touched


def test_generator_defaults_to_the_card():
    from s2p_tpu_torch.gan import S2PGenerator

    if torch.cuda.is_available():
        gen = S2PGenerator(17, ngf=8, state_freqs=2, state_embed_dim=16, mat_hidden=8)
        assert next(gen.parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            S2PGenerator(17, ngf=8, state_freqs=2, state_embed_dim=16, mat_hidden=8)


def test_trainer_defaults_to_the_card():
    from s2p_tpu_torch.gan.training import GANTrainer

    kw = dict(image_size=16, use_perceptual=False,
              generator_kwargs=dict(ngf=8, state_freqs=2, state_embed_dim=16, mat_hidden=8),
              discriminator_kwargs=dict(ndf=8, n_layers=2, num_scales=1))
    if torch.cuda.is_available():
        assert GANTrainer.create(17, **kw).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            GANTrainer.create(17, **kw)


def test_slac_and_iql_default_to_the_card():
    from s2p_tpu_torch.rl import CriticSLAC, IQLTrainer, TanhGaussianPolicy
    from s2p_tpu_torch.slac import SlacAlgorithm

    kw = dict(num_sequences=2, buffer_size=10, feature_dim=8, z1_dim=2, z2_dim=4,
              hidden_units=(8, 8))
    nets = lambda: (TanhGaussianPolicy(4, (8,), 3), CriticSLAC(4, 3, (8,)))  # noqa: E731
    if torch.cuda.is_available():
        assert SlacAlgorithm(3, **kw).device.type == "cuda"
        assert next(IQLTrainer(*nets()).policy.parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            SlacAlgorithm(3, **kw)
        with pytest.raises((RuntimeError, AssertionError)):
            IQLTrainer(*nets())


@pytest.mark.parametrize("trainer", ["CQLTrainer", "SACTrainer"])
def test_cql_and_sac_default_to_the_card(trainer):
    import s2p_tpu_torch.rl as rl

    cls = getattr(rl, trainer)
    nets = lambda: (rl.TanhGaussianPolicy(4, (8,), 3), rl.CriticSLAC(4, 3, (8,)))  # noqa: E731
    if torch.cuda.is_available():
        assert next(cls(*nets()).policy.parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            cls(*nets())


def test_metrics_default_to_the_card():
    from s2p_tpu_torch.gan.inception import inception_fid_extractor
    from s2p_tpu_torch.gan.metrics import PerceptualMetric
    from s2p_tpu_torch.gan.perceptual import LPIPSMetric

    for make in (LPIPSMetric, PerceptualMetric, inception_fid_extractor):
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                make()
