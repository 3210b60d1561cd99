"""``mujoco_finetune`` — offline→online image RL (the entry of
``run_iql_image.sh`` and ``run_cql_image.sh``).

The port of ``s2p_tpu/cli/mujoco_finetune.py``, with the same flags:

    python -m s2p_tpu_torch.cli.mujoco_finetune --env_name cheetah-run \
        --algo_type iql --image_rl --slac_representation \
        --slac_latent_model_load_dir ./slac_logs/model \
        --data_path_real real-rl.hdf5 --data_path_gen augment.hdf5 \
        --gan_checkpoint cheetah_30.pth --uncertainty_type aleatoric \
        --uncertainty_penalty_lambda 2 --gpu_id 0

It builds the DeepMind Control eval and exploration envs, the SLAC
algorithm (with a pretrained latent), ingests the real and the generated
HDF5 data (the generated next frames rendered on the device by the S2P
generator with ``--gan_checkpoint``, rewards penalized by the chosen
uncertainty), then the IQL or CQL trainer, the agents and collectors and
``BatchRLAlgorithm``, and runs the offline epochs (negative) and the online
ones. ``--image_rl`` off and ``--slac_representation`` off is the state
branch: IQL or CQL over flat observations in an ``EnvReplayBuffer``.

Reference scale: 100px frames, ``start_epoch`` −150, 151 epochs of 2,000
steps at batch 128; ``--debug`` shrinks it (2 offline epochs and 1 online,
2 steps each at batch 8, paths of at most 10 steps).

``experiment`` is two halves: the file readers and env construction
(``experiment`` itself, with ``make_slac`` and the on-device generation
of ``ingest_generated_on_device``), and ``build_image_rl``, which takes a
filled ``SlacAlgorithm`` and two envs and builds the trainer, agents,
collectors, loop and hooks, whose ``train()`` runs the experiment.
``--gpu_id``: ``0`` (the default) runs on ``cuda:0``, ``-1`` on the CPU;
without CUDA any id other than -1 is an error.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Optional, Tuple


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--exp_name", type=str, default="s2p_rl")
    p.add_argument("--env_name", type=str, default="cheetah-run")
    p.add_argument("--algo_type", type=str, default="iql", choices=["iql", "cql"])
    p.add_argument("--image_rl", action="store_true")
    p.add_argument("--slac_representation", action="store_true")
    p.add_argument("--freeze_slac", action="store_true")
    p.add_argument("--slac_latent_model_load_dir", type=str, default="")
    p.add_argument("--slac_policy_input_type", type=str, default="feature_action",
                   choices=["feature_action", "latent_z"])
    p.add_argument("--slac_obs_reset_w_same_obs", action="store_true")
    p.add_argument("--data_path_real", type=str, default=None, help="real image RL HDF5")
    p.add_argument("--data_path_gen", type=str, default=None,
                   help="S2P-generated augment HDF5")
    p.add_argument("--gan_checkpoint", type=str, default=None,
                   help="S2P generator checkpoint (.pth/.pkl): synthesize the generated "
                        "next-frames ON DEVICE while ingesting --data_path_gen (no -rl.hdf5 "
                        "file needed)")
    p.add_argument("--gan_ngf", type=int, default=64)
    p.add_argument("--data_mix_type", type=str, default="all_state_1step_random_action")
    p.add_argument("--data_mix_num_real", type=int, default=None)
    p.add_argument("--data_mix_num_gen", type=int, default=None)
    p.add_argument("--uncertainty_type", type=str, default=None)
    p.add_argument("--uncertainty_penalty_lambda", type=float, default=1.0)
    p.add_argument("--seperate_buffer", action="store_true")
    # CQL's conservatism (the reference hardcodes these in its trainer
    # table; same defaults): with_lagrange trades the fixed penalty weight
    # for a dual variable targeting lagrange_thresh
    p.add_argument("--min_q_weight", type=float, default=5.0)
    p.add_argument("--with_lagrange", action="store_true")
    p.add_argument("--lagrange_thresh", type=float, default=-1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gpu_id", type=int, default=0,
                   help="CUDA device index; -1 runs on the CPU")
    p.add_argument("--no_curl_contrastive_learning", action="store_true",
                   help="accepted for reference-CLI parity (CURL path is always off in the "
                        "shipped configs)")
    p.add_argument("--image_size", type=int, default=100)
    p.add_argument("--num_epochs", type=int, default=151)
    p.add_argument("--start_epoch", type=int, default=-150)
    p.add_argument("--num_trains_per_train_loop", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_eval_steps_per_epoch", type=int, default=None)
    p.add_argument("--max_path_length", type=int, default=None)
    p.add_argument("--scan_training", action="store_true",
                   help="each train loop as one train_many call with batches drawn on the "
                        "device")
    p.add_argument("--eval_period", type=int, default=1,
                   help="collect eval rollouts every N epochs (1 = every epoch, the "
                        "reference cadence; >1 trades eval-curve density for wall-clock "
                        "when env stepping is the bottleneck)")
    p.add_argument("--save_video_period", type=int, default=5)
    p.add_argument("--no_video", action="store_true")
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--resume_dir", type=str, default=None,
                   help="checkpoint dir: save the FULL trainer state (networks, optimizer "
                        "states, temperatures, SLAC latent and its optimizer, generator) "
                        "every epoch and resume from the latest one (data is re-ingested; "
                        "the epoch follows from the train-step count)")
    p.add_argument("--debug", action="store_true")
    return p


def make_variant(args):
    from s2p_tpu_torch.utils.config import Config

    variant = Config(vars(args))
    if args.debug:  # the reference's --debug shrink
        variant.num_epochs = 1
        variant.start_epoch = -2
        variant.num_trains_per_train_loop = 2
        variant.batch_size = 8
        variant.save_video_period = 1
    return variant


def horizons(variant, max_episode_steps: int) -> Tuple[int, int]:
    """(max_path_length, eval steps per epoch) for an env of
    ``max_episode_steps``; ``--debug`` caps paths at 10 steps."""
    max_path_length = variant["max_path_length"] or max_episode_steps
    num_eval_steps = variant["num_eval_steps_per_epoch"] or max_path_length
    if variant["debug"]:
        max_path_length = min(max_path_length, 10)
        num_eval_steps = max_path_length
    return max_path_length, num_eval_steps


def _setup_resume(variant, trainer, start_epoch: int, log):
    """Restore the latest full-state checkpoint of ``--resume_dir`` (if
    any) into ``trainer``; returns (the start epoch, advanced by the epochs
    done, and the post-epoch hook that saves one), or (start_epoch, None)
    without ``--resume_dir``."""
    d = variant.get("resume_dir")
    if not d:
        return start_epoch, None
    from s2p_tpu_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(d, max_to_keep=2)
    latest = mgr.latest_step()
    if latest is not None:
        trainer.load_full_state(mgr.restore(latest))
        start_epoch += latest // max(variant["num_trains_per_train_loop"], 1)
        log.log(f"resumed from {d} at {latest} train steps → epoch {start_epoch}")

    def save_hook(algo, epoch):
        mgr.save(trainer._n_train_steps_total, trainer.full_state())

    return start_epoch, save_hook


def ingest_generated_on_device(slac, dataset: dict, gen, uncertainty_type: Optional[str],
                               uncertainty_penalty_lambda: Optional[float]) -> Tuple[int, int]:
    """Render the augmented ``dataset``'s next frames, ``i_{t+1} =
    G(s_{t+1}, i_t)``, with the S2P generator ``gen`` on its device
    (``generate_images_for_dataset``: bf16, 256 rows at a time) and ingest
    the rows with them into the generated-data buffer (the main one unless
    SLAC keeps a separate one), rewards penalized by ``uncertainty_type``. Returns (slots
    added, frames rendered)."""
    from s2p_tpu_torch.cli.generate_images import generate_images_for_dataset

    frames = generate_images_for_dataset(dataset, gen, bf16=True)
    buf = slac.buffer_gen if slac.use_seperate_buffer else slac.buffer
    added = buf.ingest_generated(dataset, uncertainty_type, uncertainty_penalty_lambda,
                                 generated_frames=frames)
    return added, len(frames)


def experiment_logger(variant):
    """(logger, run dir) of a new run under ``--log_dir``, with
    ``variant.json``; snapshots ``itr_N.pkl`` every 10 epochs and
    ``params.pkl`` at each save."""
    from s2p_tpu_torch.utils.logging import setup_logger

    log, log_dir = setup_logger(variant["exp_name"], variant=variant,
                                base_log_dir=variant["log_dir"], seed=variant["seed"])
    log.set_snapshot_mode("gap_and_last")
    log.set_snapshot_gap(10)
    return log, log_dir


def experiment(variant) -> str:
    """The whole run: envs, data and the RL loop; returns the run's log dir."""
    from s2p_tpu_torch.cli.simple_test import resolve_device
    from s2p_tpu_torch.envs import DMC_ENVS, make_dmc
    from s2p_tpu_torch.utils.seeding import set_seed

    device = resolve_device(str(variant["gpu_id"]), flag="--gpu_id")
    set_seed(variant["seed"])
    log, log_dir = experiment_logger(variant)
    try:
        env_key = variant["env_name"]
        for known in DMC_ENVS:
            if env_key.startswith(known.split("-")[0]):
                env_key = known
                break
        size = variant["image_size"]
        eval_env, expl_env = (make_dmc(env_key, from_pixels=variant["image_rl"], height=size,
                                       width=size, seed=variant["seed"] + i) for i in (0, 1))
        if not variant["slac_representation"]:
            algo = _build_state_rl(variant, eval_env, expl_env, log, device)
        else:
            slac = _filled_slac(variant, eval_env.action_space.shape[0], log, device)
            algo = build_image_rl(variant, slac, eval_env, expl_env, log, log_dir)
        algo.train()
    finally:
        log.close()
    return log_dir


def make_slac(variant, action_dim: int, device):
    """The shipped SLAC configuration (8-step windows, feature 256, z1 32,
    z2 256, a buffer of 105k slots) at ``--image_size``, empty."""
    from s2p_tpu_torch.slac import SlacAlgorithm

    return SlacAlgorithm(action_dim=action_dim, num_sequences=8, buffer_size=int(1.05e5),
                         feature_dim=256, z1_dim=32, z2_dim=256,
                         image_size=variant["image_size"],
                         use_seperate_buffer=variant["seperate_buffer"], seed=variant["seed"],
                         device=device)


def _filled_slac(variant, action_dim: int, log, device):
    """``make_slac`` with its latent and both datasets ingested."""
    slac = make_slac(variant, action_dim, device)
    if variant["slac_latent_model_load_dir"]:
        d = variant["slac_latent_model_load_dir"]
        path = d if osp.isfile(d) else _find_latent(d)
        slac.load_latent(path)
        log.log(f"loaded SLAC latent from {path}")

    if variant["data_path_real"]:
        n = slac.load_data_in_buffer(variant["data_path_real"],
                                     data_num=variant["data_mix_num_real"])
        log.log(f"real data: {n} sequence slots")
    if variant["data_path_gen"]:
        if variant.get("gan_checkpoint"):
            from s2p_tpu_torch.data.hdf5 import load_augment_dataset
            from s2p_tpu_torch.gan import S2PGenerator
            from s2p_tpu_torch.gan.convert import load_generator_checkpoint

            gen_ds = load_augment_dataset(variant["data_path_gen"], variant["data_mix_num_gen"])
            gen = S2PGenerator(gen_ds["next_observations"].shape[1],
                               image_size=gen_ds["image_observations"].shape[1],
                               ngf=variant["gan_ngf"], device=device)
            load_generator_checkpoint(variant["gan_checkpoint"], gen)
            n, frames = ingest_generated_on_device(slac, gen_ds, gen,
                                                   variant["uncertainty_type"],
                                                   variant["uncertainty_penalty_lambda"])
            log.log(f"synthesized {frames} next-frames on device from "
                    f"{variant['gan_checkpoint']}")
        else:
            n = slac.load_data_in_buffer(
                variant["data_path_gen"], data_num=variant["data_mix_num_gen"],
                generated_for_slac=True, data_mix_type=variant["data_mix_type"],
                uncertainty_type=variant["uncertainty_type"],
                uncertainty_penalty_lambda=variant["uncertainty_penalty_lambda"])
        log.log(f"generated data: {n} sequence slots "
                f"(uncertainty={variant['uncertainty_type']}, "
                f"lambda={variant['uncertainty_penalty_lambda']})")
    if len(slac.buffer) == 0:
        raise ValueError("no data ingested: pass --data_path_real")
    return slac


def build_image_rl(variant, slac, eval_env, expl_env, log, log_dir: str):
    """The image branch after ingestion: the IQL or CQL trainer over the
    filled ``slac`` (on its device), the eval (deterministic) and
    exploration agents, which act with the trainer's policy module and so
    with its latest weights, the collectors, ``BatchRLAlgorithm`` and the
    resume and video hooks; returns the loop, whose ``train()`` runs it."""
    from s2p_tpu_torch.core import BatchRLAlgorithm, VideoSaveFunction
    from s2p_tpu_torch.rl import CQLTrainer, CriticSLAC, IQLTrainer, TanhGaussianPolicy
    from s2p_tpu_torch.samplers import MdpPathCollector, PolicyAgent

    seed, input_type = variant["seed"], variant["slac_policy_input_type"]
    max_path_length, num_eval_steps = horizons(variant, eval_env._max_episode_steps)
    action_dim = slac.action_dim
    policy_input_dim = (slac.feature_action_dim if input_type == "feature_action"
                        else slac.z_dim)
    policy = TanhGaussianPolicy(policy_input_dim, (1024, 1024), action_dim, seed=seed)
    critic = CriticSLAC(slac.z_dim, action_dim, (1024, 1024), seed=seed + 1)
    common = dict(discount=0.99, policy_lr=1e-4, qf_lr=3e-4, reward_scale=1.0, slac_algo=slac,
                  slac_policy_input_type=input_type, freeze_slac=variant["freeze_slac"],
                  seed=seed, device=slac.device)
    if variant["algo_type"] == "iql":
        trainer = IQLTrainer(policy, critic, soft_target_tau=0.005, beta=1.0 / 10,
                             quantile=0.7, clip_score=100, target_update_period=2, **common)
    else:
        trainer = CQLTrainer(policy, critic, soft_target_tau=5e-3, policy_eval_start=40_000,
                             temp=1.0, min_q_version=3, min_q_weight=variant["min_q_weight"],
                             num_random=10, with_lagrange=variant["with_lagrange"],
                             lagrange_thresh=variant["lagrange_thresh"], **common)
    eval_agent = PolicyAgent(trainer.policy, deterministic=True, seed=seed)
    expl_agent = PolicyAgent(trainer.policy, deterministic=False, seed=seed + 1)
    slac_kw = dict(slac_algo=slac, slac_policy_input_type=input_type,
                   slac_obs_reset_w_same_obs=variant["slac_obs_reset_w_same_obs"])
    start_epoch, save_hook = _setup_resume(variant, trainer, variant["start_epoch"], log)
    algo = BatchRLAlgorithm(
        trainer=trainer,
        exploration_env=expl_env, evaluation_env=eval_env,
        exploration_data_collector=MdpPathCollector(expl_env, expl_agent, **slac_kw),
        evaluation_data_collector=MdpPathCollector(eval_env, eval_agent, **slac_kw),
        replay_buffer=slac.buffer,
        replay_buffer_gen=slac.buffer_gen,
        batch_size=variant["batch_size"],
        max_path_length=max_path_length,
        num_epochs=variant["num_epochs"],
        num_eval_steps_per_epoch=num_eval_steps,
        num_expl_steps_per_train_loop=max_path_length,
        num_trains_per_train_loop=variant["num_trains_per_train_loop"],
        start_epoch=start_epoch,
        slac_representation=True,
        logger=log,
        seed=seed,
        scan_training=variant.get("scan_training", False),
        eval_period=variant.get("eval_period", 1),
    )
    if save_hook is not None:
        algo.post_epoch_funcs.append(save_hook)
    if not variant["no_video"]:
        algo.post_epoch_funcs.append(VideoSaveFunction(
            eval_env, eval_agent, log_dir, tag="eval",
            save_video_period=variant["save_video_period"], horizon=max_path_length,
            **slac_kw))
    return algo


def _build_state_rl(variant, eval_env, expl_env, log, device):
    """State-observation offline RL (the reference's ``image_rl`` off
    branch): IQL or CQL over flat observations loaded from the HDF5 into an
    ``EnvReplayBuffer``; returns the loop, untrained."""
    from s2p_tpu_torch.core import BatchRLAlgorithm
    from s2p_tpu_torch.data.env_replay_buffer import EnvReplayBuffer
    from s2p_tpu_torch.data.hdf5 import load_state_dataset
    from s2p_tpu_torch.data.path_loaders import load_hdf5
    from s2p_tpu_torch.rl import CQLTrainer, CriticSLAC, IQLTrainer, TanhGaussianPolicy
    from s2p_tpu_torch.samplers import MdpPathCollector, PolicyAgent

    if variant["image_rl"]:
        raise ValueError("the state RL branch takes no --image_rl (add --slac_representation)")
    if not variant["data_path_real"]:
        raise ValueError("state RL needs --data_path_real")
    seed = variant["seed"]
    max_path_length, num_eval_steps = horizons(variant, eval_env._max_episode_steps)
    obs_dim = eval_env.observation_space.shape[0]
    action_dim = eval_env.action_space.shape[0]
    buf = EnvReplayBuffer(int(2e6), eval_env, device=device)
    n = load_hdf5(load_state_dataset(variant["data_path_real"], variant["data_mix_num_real"]),
                  buf)
    log.log(f"state-RL buffer: {n} transitions")

    policy = TanhGaussianPolicy(obs_dim, (256, 256), action_dim, seed=seed)
    critic = CriticSLAC(obs_dim, action_dim, (256, 256), seed=seed + 1)
    common = dict(discount=0.99, policy_lr=1e-4, qf_lr=3e-4, seed=seed, device=device)
    if variant["algo_type"] == "iql":
        trainer = IQLTrainer(policy, critic, beta=1.0 / 10, quantile=0.7, clip_score=100,
                             soft_target_tau=0.005, target_update_period=2, **common)
    else:
        trainer = CQLTrainer(policy, critic, soft_target_tau=5e-3, policy_eval_start=40_000,
                             min_q_weight=variant["min_q_weight"],
                             with_lagrange=variant["with_lagrange"],
                             lagrange_thresh=variant["lagrange_thresh"], **common)
    eval_agent = PolicyAgent(trainer.policy, deterministic=True, seed=seed)
    expl_agent = PolicyAgent(trainer.policy, seed=seed + 1)
    start_epoch, save_hook = _setup_resume(variant, trainer, variant["start_epoch"], log)
    algo = BatchRLAlgorithm(
        trainer=trainer,
        exploration_env=expl_env, evaluation_env=eval_env,
        exploration_data_collector=MdpPathCollector(expl_env, expl_agent),
        evaluation_data_collector=MdpPathCollector(eval_env, eval_agent),
        replay_buffer=buf,
        batch_size=variant["batch_size"],
        max_path_length=max_path_length,
        num_epochs=variant["num_epochs"],
        num_eval_steps_per_epoch=num_eval_steps,
        num_expl_steps_per_train_loop=max_path_length,
        num_trains_per_train_loop=variant["num_trains_per_train_loop"],
        start_epoch=start_epoch,
        logger=log,
        seed=seed,
        eval_period=variant.get("eval_period", 1),
    )
    if save_hook is not None:
        algo.post_epoch_funcs.append(save_hook)
    return algo


def _find_latent(d: str) -> str:
    for name in ("latent.pkl", "latent.pth"):
        p = osp.join(d, name)
        if osp.exists(p):
            return p
    raise FileNotFoundError(f"no latent checkpoint in {d}")


def main(argv: Optional[list] = None) -> str:
    args = build_parser().parse_args(argv)
    return experiment(make_variant(args))


if __name__ == "__main__":
    main()
