"""``train_gan`` — S2P GAN training on the card.

The port of ``s2p_tpu/cli/train_gan.py``, with the same flags and defaults:

    python -m s2p_tpu_torch.cli.train_gan --dataroot=./datasets/cheetah.hdf5 \
        --env_type=cheetah --netG=s2p --batchSize=16 --bf16 --gpu_ids=0

One ``train_step`` runs the D update and then the G update
(``s2p_tpu_torch.gan.training``). ``--scan_chunk > 1`` stages the dataset on
the device as uint8 and runs chunks of updates on batches sampled there
(``GANTrainer.train_many``). Every ``--save_epoch_freq`` epochs (and at the
end) the generator is written as ``{env}_{epoch}.pkl`` (JAX params) and
``.pth`` (state dict); the best held-out PSNR so far as ``{env}_best``.

``--gpu_ids``: ``0`` (the default) runs on ``cuda:0``, ``-1`` on the CPU.
Without CUDA any id other than -1 is an error; the CLI never falls back to
the CPU on its own.

Data-parallel training over N processes, one per card, under ``torchrun``
(the JAX CLI's multi-device branch):

    torchrun --nproc_per_node N -m s2p_tpu_torch.cli.train_gan \
        --dataroot cheetah.hdf5,walker.hdf5 --gpu_ids 0,1,... --bf16

Local rank r runs on ``--gpu_ids``' r-th card (NCCL when every rank has
its own; ``0,0`` puts two ranks on one card over gloo, ``-1`` runs every
rank on the CPU over gloo). ``--batchSize`` is the global batch and must
divide over the ranks. The per-step path draws the same shuffled batches
on every rank and trains each rank on its contiguous part; the scanned
path (``--scan_chunk > 1``) stages each rank's contiguous part of the
dataset on its card (``GANTrainer.train_many_dp``), after dropping the
trailing rows beyond a multiple of the ranks. Gradients and metrics are
averaged over the ranks every step. Parameters and optimizer state are
broadcast from rank 0 after creation, ``--init_g`` and ``--resume_dir``;
rank 0 alone logs, evaluates and writes checkpoints and the resume state,
and the other ranks wait for it at the end of each epoch.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataroot", type=str, required=True,
                   help="HDF5 path; comma-separate for multi-env training")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (fp32 params/optimizer)")
    p.add_argument("--env_type", type=str, default="cheetah")
    p.add_argument("--netG", type=str, default="s2p",
                   choices=["s2p", "sat_state", "sat_image"])
    p.add_argument("--batchSize", type=int, default=16)
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="CUDA device index; under torchrun, local rank r takes the r-th of "
                        "a comma list; -1 runs on the CPU")
    p.add_argument("--niter", type=int, default=30, help="training epochs")
    p.add_argument("--save_epoch_freq", type=int, default=10)
    p.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--num_D", type=int, default=2, help="discriminator scales")
    p.add_argument("--n_layers_D", type=int, default=4)
    p.add_argument("--g_lr", type=float, default=1e-4)
    p.add_argument("--d_lr", type=float, default=4e-4)
    p.add_argument("--lambda_L1", type=float, default=10.0)
    p.add_argument("--lambda_feat", type=float, default=10.0)
    p.add_argument("--lambda_vgg", type=float, default=10.0)
    p.add_argument("--r1_gamma", type=float, default=1.0,
                   help="R1 gradient penalty on real images (StyleGAN2 convention; "
                        "0 disables and reproduces the reference's exact protocol)")
    p.add_argument("--r1_interval", type=int, default=16,
                   help="lazy R1: apply the penalty every k-th D update, scaled by k "
                        "(1 = every update)")
    p.add_argument("--d_every", type=int, default=1,
                   help="update D only every k-th step (1 = reference behavior)")
    p.add_argument("--no_vgg_loss", action="store_true")
    p.add_argument("--vgg_weights", type=str, default=None,
                   help="torchvision vgg19 .pth for the perceptual loss")
    p.add_argument("--data_num", type=int, default=None,
                   help="truncate dataset (smoke runs)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="hard cap on total grad steps (smoke runs)")
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--scan_chunk", type=int, default=1,
                   help=">1 stages the whole dataset on the device and runs that many "
                        "D+G updates per chunk on batches sampled there (uniform, with "
                        "replacement; 1 = per-batch epoch shuffle)")
    p.add_argument("--eval_interval", type=int, default=1,
                   help="evaluate PSNR/SSIM (and FID when enough samples) every N "
                        "epochs; 0 disables")
    p.add_argument("--eval_num", type=int, default=256,
                   help="held-out pairs used for evaluation")
    p.add_argument("--no_save_best", action="store_true",
                   help="disable the eval-driven {env}_best.pkl/.pth export")
    p.add_argument("--init_g", type=str, default=None,
                   help="initialize the generator from a saved checkpoint (.pkl JAX "
                        "params or .pth state dict) before training")
    p.add_argument("--resume_dir", type=str, default=None,
                   help="checkpoint dir: saves the full train state (G, D, both "
                        "optimizers, best PSNR) per epoch and resumes from the latest")
    return p


def evaluate_generator(trainer, ds, n: int, batch_size: int = 64) -> dict:
    """PSNR/SSIM of one-step generation against the ground-truth next frames
    on the first ``n`` pairs, with ``psnr_env{i}``/``ssim_env{i}`` columns
    over the first ``n`` pairs of each env of a multi-env dataset (the
    pooled metrics then cover that union), and FID over VGG features when
    there are at least 128 pairs."""
    from s2p_tpu_torch.gan.metrics import compute_fid, evaluate_pairs, vgg_fid_extractor
    from s2p_tpu_torch.gan.training import _to_signed

    dev = trainer.device

    def gen_pairs(sub) -> tuple:
        m = min(n, len(sub))
        fakes, reals = [], []
        for lo in range(0, m, batch_size):
            b = sub.eval_batch(lo, min(batch_size, m - lo))
            prev = _to_signed(torch.as_tensor(b["prev_image"], device=dev))
            fakes.append(trainer.generate(torch.as_tensor(b["state"], device=dev), prev))
            reals.append(_to_signed(torch.as_tensor(b["target_image"], device=dev)))
        return fakes, reals

    per_env = {}
    if ds.n_envs > 1:
        fakes, reals = [], []
        for env in range(ds.n_envs):
            f, r = gen_pairs(ds.env_subset(env))
            env_metrics = evaluate_pairs(torch.cat(f), torch.cat(r))
            per_env.update({f"{k}_env{env}": v for k, v in env_metrics.items()})
            fakes += f
            reals += r
    else:
        fakes, reals = gen_pairs(ds)
    out = evaluate_pairs(torch.cat(fakes), torch.cat(reals))
    out.update(per_env)
    if sum(len(f) for f in fakes) >= 128:  # Fréchet stats need a reasonable sample
        out["fid_vgg"] = compute_fid(vgg_fid_extractor(device=dev), reals, fakes)
    return out


class _Silent:
    """The logger of a rank other than 0: rank 0 alone logs."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def rank_devices(gpu_ids: str) -> list:
    """The device of each local rank under torchrun (of one process when
    not under it): the r-th id of ``gpu_ids`` for local rank r, or the CPU
    for every rank with ``-1``."""
    from s2p_tpu_torch.cli.simple_test import resolve_device

    ids = gpu_ids.split(",")
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if int(ids[0]) < 0:
        return [torch.device("cpu")] * n_local
    if len(ids) < n_local:
        raise ValueError(f"--gpu_ids={gpu_ids} names {len(ids)} card(s) for {n_local} "
                         "local ranks")
    return [resolve_device(i) for i in ids[:n_local]]


def main(argv: Optional[list] = None) -> Optional[str]:
    """Trains; returns rank 0's log dir (None on the other ranks)."""
    args = build_parser().parse_args(argv)

    from s2p_tpu_torch.parallel import (MeshSpec, make_mesh, shard_batch, shard_pytree,
                                        state_checksum)
    from s2p_tpu_torch.parallel.distributed import (
        initialize_distributed, local_rank, ranks_backend)

    devices = rank_devices(args.gpu_ids)
    device = devices[local_rank()]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    distributed = initialize_distributed(backend=ranks_backend(devices), device=device)
    mesh = make_mesh(MeshSpec(data=-1, model=1))
    n_data, rank = mesh.shape["data"], mesh.coords["data"]
    if args.batchSize % n_data:
        raise ValueError(f"batchSize {args.batchSize} must divide over {n_data} data-parallel "
                         "devices")

    from s2p_tpu_torch.data.pair_dataset import S2PPairDataset
    from s2p_tpu_torch.gan.convert import load_generator_checkpoint, save_generator_checkpoint
    from s2p_tpu_torch.gan.losses import GANLossConfig
    from s2p_tpu_torch.gan.training import GANOptConfig, GANTrainer
    from s2p_tpu_torch.utils.logging import setup_logger
    from s2p_tpu_torch.utils.seeding import set_seed

    set_seed(args.seed)
    logger, log_dir = (setup_logger(f"s2p_{args.env_type}", variant=vars(args),
                                    base_log_dir=args.log_dir, seed=args.seed)
                       if rank == 0 else (_Silent(), None))

    ds = S2PPairDataset.from_hdf5(args.dataroot, args.data_num)
    H = ds.image_shape[0]
    logger.log(f"dataset: {len(ds)} pairs, image {ds.image_shape}, state_dim {ds.state_dim}")
    if ds.n_envs > 1:
        for i, root in enumerate(p for p in args.dataroot.split(",") if p):
            logger.log(f"  env{i} = {root} ({int((ds.env_ids == i).sum())} pairs; eval "
                       f"columns psnr_env{i}/ssim_env{i})")

    vgg_sd = None
    if args.vgg_weights:
        from s2p_tpu_torch.gan.convert import load_pth
        from s2p_tpu_torch.gan.perceptual import load_torch_vgg19

        vgg_sd = load_torch_vgg19(load_pth(args.vgg_weights))

    trainer = GANTrainer.create(
        ds.state_dim, image_size=H, channels=ds.image_shape[-1],
        generator_kwargs=dict(ngf=args.ngf, mat_mode="mat" if args.netG == "s2p" else args.netG),
        discriminator_kwargs=dict(num_scales=args.num_D, ndf=args.ndf, n_layers=args.n_layers_D),
        opt_cfg=GANOptConfig(g_lr=args.g_lr, d_lr=args.d_lr),
        loss_cfg=GANLossConfig(lambda_l1=args.lambda_L1, lambda_feat=args.lambda_feat,
                               lambda_vgg=args.lambda_vgg, r1_gamma=args.r1_gamma,
                               r1_interval=args.r1_interval),
        use_perceptual=not args.no_vgg_loss, vgg_state_dict=vgg_sd,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        d_every=args.d_every, seed=args.seed, device=device, dp_group=mesh.groups["data"])

    if args.init_g:
        load_generator_checkpoint(args.init_g, trainer.generator)
        logger.log(f"generator initialized from {args.init_g}")

    os.makedirs(args.checkpoints_dir, exist_ok=True)

    def save(tag) -> None:
        base = osp.join(args.checkpoints_dir, f"{args.env_type}_{tag}")
        save_generator_checkpoint(base, trainer.generator)
        print(f"saved checkpoint {base}.pkl/.pth")

    ckpt_mgr = None
    start_epoch = 1
    best_psnr, best_epoch = float("-inf"), None
    if args.resume_dir:
        from s2p_tpu_torch.utils.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(args.resume_dir, max_to_keep=2)
        latest = ckpt_mgr.latest_step()
        if latest is not None:
            state = ckpt_mgr.restore(latest)
            trainer.load_state_dict(state)
            bp, be = state["best"]
            if be >= 0:
                best_psnr, best_epoch = float(bp), int(be)
            start_epoch = latest + 1
            logger.log(f"resumed from {args.resume_dir} at epoch {latest}"
                       + (f" (best PSNR {best_psnr:.2f} @ epoch {best_epoch})"
                          if best_epoch is not None else ""))
    if distributed:
        replicas = (trainer.generator, trainer.discriminator, trainer.g_opt, trainer.d_opt)
        for obj in replicas:
            shard_pytree(mesh, obj)
        print(f"rank {rank} of {n_data} on {device}: start epoch {start_epoch}, steps "
              f"{trainer.g_step}/{trainer.d_step}, state checksum {state_checksum(*replicas)}",
              flush=True)

    rng = np.random.RandomState(args.seed + start_epoch)
    step = 0
    last_eval = None
    t_start = time.time()

    data = None
    if args.scan_chunk > 1:
        # each rank stages its contiguous shard of the rows (at one process:
        # every row), at 1 B/px, once, in train_many_dp's first call
        n = len(ds) - len(ds) % n_data
        if n != len(ds):
            logger.log(f"DP sharding: dropped {len(ds) - n} trailing row(s) to make the "
                       f"dataset divide over {n_data} devices ({n} rows kept)")
        data = dict(prev_image=ds.prev_images, state=ds.states, target_image=ds.target_images)
        logger.log(f"scan_chunk={args.scan_chunk}: dataset staged on {device} "
                   f"({sum(v[:n].nbytes for v in data.values()) / n_data / 1e9:.2f} GB"
                   + (f", sharded over {n_data} devices)" if n_data > 1 else ")"))
        sampler = torch.Generator(device=device)
        # a sampling stream per (seed, epoch, chunk), whatever the epoch
        # length, and per rank under data parallelism
        stream = (rank,) if n_data > 1 else ()

    def host(metrics) -> dict:
        return {k: float(v) for k, v in metrics.items()}

    for epoch in range(start_epoch, args.niter + 1):
        if data is not None:
            # one epoch = len(ds)//batchSize updates, run in chunks
            steps_per_epoch = max(len(ds) // args.batchSize, 1)
            if args.max_steps:
                steps_per_epoch = min(steps_per_epoch, args.max_steps - step)
            done_in_epoch = 0
            while done_in_epoch < steps_per_epoch:
                chunk = min(args.scan_chunk, steps_per_epoch - done_in_epoch)
                sampler.manual_seed(hash((args.seed, epoch, done_in_epoch) + stream) % 2**63)
                metrics = trainer.train_many_dp(mesh, data, chunk, args.batchSize, sampler)
                step += chunk
                done_in_epoch += chunk
                m = host(metrics)
                logger.log(f"epoch {epoch} step {step} "
                           f"({step / max(time.time() - t_start, 1e-9):.1f} it/s cum): "
                           + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
        else:
            # every rank draws the same batches and trains on its part
            for batch in ds.batches(args.batchSize, rng):
                metrics = trainer.train_step(shard_batch(mesh, batch))
                step += 1
                if step % args.log_interval == 0:
                    logger.log(f"epoch {epoch} step {step}: " + " ".join(
                        f"{k}={v:.4f}" for k, v in sorted(host(metrics).items())))
                if args.max_steps and step >= args.max_steps:
                    break
        logger.record_tabular("epoch", epoch)
        logger.record_tabular("step", step)
        logger.record_dict(host(metrics))
        if rank == 0:  # evaluation, checkpoints and the progress row
            if args.eval_interval and (epoch == start_epoch
                                       or epoch % args.eval_interval == 0):
                last_eval = evaluate_generator(trainer, ds, args.eval_num)
                if not args.no_save_best and last_eval["psnr"] > best_psnr:
                    best_psnr, best_epoch = last_eval["psnr"], epoch
                    save("best")
                    logger.log(f"new best PSNR {best_psnr:.2f} at epoch {epoch} "
                               f"→ {args.env_type}_best.pkl")
            if last_eval is not None:
                if not args.no_save_best:
                    # numeric before any finite-PSNR eval: the frozen csv
                    # header must stay parseable
                    logger.record_tabular(
                        "eval/best_psnr", best_psnr if best_epoch is not None else float("nan"))
                    logger.record_tabular(
                        "eval/best_epoch", best_epoch if best_epoch is not None else -1)
                # every epoch, so the frozen csv header holds the eval columns
                logger.record_dict(last_eval, prefix="eval/")
            logger.record_tabular("time_s", round(time.time() - t_start, 1))
            logger.dump_tabular()
            if epoch % args.save_epoch_freq == 0 or epoch == args.niter:
                save(epoch)
            if ckpt_mgr is not None:
                state = trainer.state_dict()
                # carry the best-PSNR tracker through a resume, so a worse
                # later eval cannot overwrite {env}_best
                state["best"] = [best_psnr, -1.0 if best_epoch is None else float(best_epoch)]
                ckpt_mgr.save(epoch, state)
        if distributed:
            dist.barrier()  # the other ranks wait for rank 0's eval and checkpoints
        if args.max_steps and step >= args.max_steps:
            break
    logger.close()
    if distributed:
        dist.destroy_process_group()
    return log_dir


if __name__ == "__main__":
    main()
