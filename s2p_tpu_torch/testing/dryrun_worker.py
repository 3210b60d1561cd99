"""One rank of ``s2p_tpu_torch.cli.dryrun.dryrun_multichip``: the legs of
the JAX package's multi-device dry run (``__graft_entry__.py``) through the
port's own API, at its shapes.

``spawn_ranks(run, world, (device_type, out_dir))`` runs every leg on each
rank of a data mesh over all ranks; rank r runs on ``cuda:(r mod
device_count)`` (``device_type`` "cuda") or the CPU, over NCCL when every
rank has a card of its own, else gloo. Every rank draws the same global
data from one ``RandomState(0)`` in the JAX dry run's order (plus the
state leg's batch indices and CQL draws, which JAX draws on the device)
and takes its contiguous part of each batch (``shard_batch``), as
``P('data')`` lays it out. Each rank saves ``{out_dir}/rank{r}.pt``: per leg its name, wall
seconds, metrics, the MAT-norm kernels' launches (forward, backward) and
a digest of the parameters it trained (``params_digest``: equal on every
rank only when the gradients were averaged), and rank 0's printed lines.
A failing leg raises, and the rank exits non-zero.

The legs:

- ``gan``: one data-parallel ``GANTrainer.train_step`` (G and D, hinge + FM
  + L1 + VGG) at 32px on a global batch of 2·world;
- ``iql_slac``: one IQL + SLAC ``train`` (latent frozen) on 64px windows;
- ``gan_dp_scan``: ``GANTrainer.train_many_dp`` for 2 steps, after which G
  has taken 3;
- ``state_rl``: the state IQL and CQL ``train_many_dp`` over a replay
  buffer of 8·world rows, 4 steps each, on global batch indices and CQL
  draws from the shared ``RandomState`` (each rank takes its rows of
  them), held to one process's ``train_many`` on the whole of them within
  ``STATE_TOL`` in every parameter;
- ``image_rl``: the image IQL and CQL ``train_many_dp`` with the joint
  latent step, half of each batch from a second (generated) frame pool;
- ``tp`` (world even and ≥ 4): the generator tensor-parallel on a
  (world/2) × 2 data × model mesh, held to its unsharded forward within
  ``TP_TOL``.

Two shapes differ from JAX's where the port samples per rank: the SLAC
latent batch is ``max(2, world)`` (each rank draws a whole share of it) and
the image legs' global batch ``max(4, 2·world)`` (a real and a generated
half on each rank).
"""

from __future__ import annotations

import copy
import hashlib
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from s2p_tpu_torch.data.hdf5 import make_synthetic_rl_dataset
from s2p_tpu_torch.gan import cuda_kernels
from s2p_tpu_torch.gan.generator import S2PGenerator
from s2p_tpu_torch.gan.training import GANTrainer
from s2p_tpu_torch.parallel import (MeshSpec, make_mesh, rank_seed, shard_batch,
                                    shard_pytree)
from s2p_tpu_torch.parallel.distributed import initialize_distributed, ranks_backend
from s2p_tpu_torch.rl import (CQLTrainer, CriticSLAC, IQLTrainer, TanhGaussianPolicy,
                              train_many_dp)
from s2p_tpu_torch.rl.scan_utils import train_many
from s2p_tpu_torch.slac import SlacAlgorithm
from s2p_tpu_torch.testing.rl_dp_worker import ROW_KEYS, state_buffer
from s2p_tpu_torch.testing.tp_worker import sharded_forward

STATE_DIM = 17  # cheetah-run
ROWS = 2  # a rank's rows of the GAN, IQL + SLAC and state legs' global batch (2·world)
GAN_SIZE = 32
GAN_G = dict(ngf=8, state_embed_dim=16, mat_hidden=16, state_freqs=2, n_up=3)
GAN_D = dict(num_scales=2, ndf=8, n_layers=2)
NS, HW, ACT = 4, 64, 4  # SLAC windows, frame size, action dim
SLAC = dict(action_dim=ACT, num_sequences=NS, feature_dim=16, z1_dim=4, z2_dim=8,
            hidden_units=(16, 16), image_size=HW)
HIDDEN = (16,)
STATE_OBS, STATE_STEPS, STATE_TOL = 6, 4, 1e-5
IMAGE_STEPS, GAN_DP_STEPS = 2, 2
TP_G = dict(image_size=32, ngf=32, state_embed_dim=64, mat_hidden=64, state_freqs=2, n_up=2)
TP_MIN_FEATURES, TP_TOL = 64, 1e-4


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def latent_batch(world: int) -> int:
    return max(2, world)


def image_batch(world: int) -> int:
    return max(4, 2 * world)


def gan_trainer(device, group) -> GANTrainer:
    """The dry run's GAN: G, D and the VGG19 of the perceptual loss from
    seeds 0, 1 and 2, averaged over ``group`` (None: a single process)."""
    return GANTrainer.create(STATE_DIM, image_size=GAN_SIZE, generator_kwargs=GAN_G,
                             discriminator_kwargs=GAN_D, use_perceptual=True, seed=0,
                             device=device, dp_group=group)


def gan_batch(rs: np.random.RandomState, b: int) -> Dict[str, np.ndarray]:
    """A global GAN batch of ``b`` rows drawn from ``rs`` in JAX's order."""
    return dict(
        prev_image=rs.randint(0, 255, (b, GAN_SIZE, GAN_SIZE, 3), dtype=np.uint8),
        state=rs.randn(b, STATE_DIM).astype(np.float32),
        target_image=rs.randint(0, 255, (b, GAN_SIZE, GAN_SIZE, 3), dtype=np.uint8),
    )


def slac_pool(device, group, world: int, seed: int, n_episodes: int, episode_len: int,
              buffer_size: int) -> SlacAlgorithm:
    slac = SlacAlgorithm(buffer_size=buffer_size, batch_size_latent=latent_batch(world),
                         seed=seed, device=device, dp_group=group, **SLAC)
    slac.buffer.ingest_real(make_synthetic_rl_dataset(
        n_episodes=n_episodes, episode_len=episode_len, obs_dim=5, act_dim=ACT, img_hw=HW,
        seed=seed))
    return slac


def rl_trainer(cls, device, group, obs_dim: int, policy_input_dim: int, seed: int, **kw):
    return cls(TanhGaussianPolicy(policy_input_dim, HIDDEN, ACT),
               CriticSLAC(obs_dim, ACT, HIDDEN), seed=seed, device=device, dp_group=group,
               **kw)


def params_digest(*objs) -> str:
    """sha256 of the parameters of ``objs`` (modules or tensors), in order:
    two ranks' digests are equal only when their parameters are bit-equal."""
    h = hashlib.sha256()
    for obj in objs:
        for p in (obj.parameters() if isinstance(obj, torch.nn.Module) else [obj]):
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def trained(tr) -> list:
    """What an RL trainer's steps update: the policy, critic and target
    networks, CQL's temperatures and the SLAC latent model."""
    objs = [tr.policy, tr.critic, tr.target_q]
    objs += [getattr(tr, k) for k in ("log_alpha", "log_alpha_prime") if hasattr(tr, k)]
    return objs + ([tr.slac_algo.latent] if tr.slac_algo is not None else [])


def max_param_diff(a: list, b: list) -> float:
    """max |a − b| over the parameters of two lists of modules or tensors."""
    flat = lambda objs: [p for o in objs  # noqa: E731
                         for p in (o.parameters() if isinstance(o, torch.nn.Module) else [o])]
    return max((x - y).abs().max().item() for x, y in zip(flat(a), flat(b), strict=True))


def cql_draws(rs: np.random.RandomState, b: int, num_random: int) -> Dict[str, np.ndarray]:
    """One state CQL step's draws for a global batch of ``b`` (``CQLTrainer.
    _step``'s ``draws``), the tiled ones ``num_random`` rows per batch row."""
    normal = lambda n: rs.randn(n, ACT).astype(np.float32)  # noqa: E731
    return dict(pi=normal(b), next=normal(b),
                random=rs.uniform(-1, 1, (b * num_random, ACT)).astype(np.float32),
                pi_tiled=normal(b * num_random), next_tiled=normal(b * num_random))


def rank_rows(x, rank: int, world: int):
    """This rank's contiguous share of ``x``'s rows (tiled rows follow
    their batch row)."""
    k = len(x) // world
    return x[rank * k:(rank + 1) * k]


def finite(label: str, metrics: Dict[str, torch.Tensor], keys) -> Dict[str, float]:
    values = {k: float(metrics[k]) for k in keys}
    if not all(np.isfinite(v) for v in values.values()):
        raise RuntimeError(f"{label}: non-finite metrics {values}")
    return values


def leg_names(world: int) -> List[str]:
    """The legs a dry run over ``world`` ranks runs, in order."""
    legs = ["gan", "iql_slac", "gan_dp_scan", "state_rl", "image_rl"]
    return legs + (["tp"] if world % 2 == 0 and world >= 4 else [])


class Legs:
    """The dry run's legs on this rank, in JAX's order; each returns its
    metrics, the text of its line after ``dryrun_multichip(N): `` and what
    it trained (for ``params_digest``)."""

    def __init__(self, mesh, device: torch.device, world: int):
        self.mesh, self.device, self.world = mesh, device, world
        self.group = mesh.groups["data"]
        self.rank = dist.get_rank(self.group)
        self.rs = np.random.RandomState(0)
        self.b = ROWS * world
        self.trainer = None

    def gan(self) -> Tuple[Dict[str, float], str, list]:
        self.trainer = tr = gan_trainer(self.device, self.group)
        # replicate parameters and optimizer state from rank 0, shard the batch
        for obj in (tr.generator, tr.discriminator, tr.g_opt, tr.d_opt):
            shard_pytree(self.mesh, obj)
        m = finite("GAN", tr.train_step(shard_batch(self.mesh, gan_batch(self.rs, self.b))),
                   ("g_loss", "d_loss"))
        return (m, f"GAN ok  g_loss={m['g_loss']:.4f} d_loss={m['d_loss']:.4f}",
                [tr.generator, tr.discriminator])

    def iql_slac(self) -> Tuple[Dict[str, float], str, list]:
        slac = slac_pool(self.device, self.group, self.world, 0, 1, 8, 100)
        rl = rl_trainer(IQLTrainer, self.device, self.group, slac.z_dim,
                        slac.feature_action_dim, 0, slac_algo=slac, freeze_slac=True)
        for obj in (rl.policy, rl.critic, rl.target_q):
            shard_pytree(self.mesh, obj)
        rs, b = self.rs, self.b
        batch = dict(
            observations=rs.rand(b, NS + 1, HW, HW, 3).astype(np.float32),
            actions=np.tanh(rs.randn(b, NS, ACT)).astype(np.float32),
            rewards=rs.rand(b, 1).astype(np.float32),
            terminals=np.zeros((b, 1), np.float32),
        )
        m = finite("IQL+SLAC", rl.train(shard_batch(self.mesh, batch)),
                   ("critic_loss", "policy_loss"))
        return (m, f"IQL+SLAC ok  critic={m['critic_loss']:.4f} policy={m['policy_loss']:.4f}",
                trained(rl))

    def gan_dp_scan(self) -> Tuple[Dict[str, float], str, list]:
        tr = self.trainer
        data = gan_batch(self.rs, 2 * self.world)
        sampler = torch.Generator(device=self.device).manual_seed(rank_seed(3, self.group))
        m = finite("GAN DP scan", tr.train_many_dp(self.mesh, data, GAN_DP_STEPS, self.b,
                                                   sampler), ("g_loss",))
        if tr.g_step != 1 + GAN_DP_STEPS:  # one per-step update, then the scanned ones
            raise RuntimeError(f"GAN DP scan: G took {tr.g_step} steps, not {1 + GAN_DP_STEPS}")
        m["g_step"] = tr.g_step
        return m, f"GAN DP scan ok  g_loss={m['g_loss']:.4f}", [tr.generator, tr.discriminator]

    def state_rl(self) -> Tuple[Dict[str, float], str, list]:
        rs, n, b = self.rs, 8 * self.world, self.b
        draws = [(rs.randn(STATE_OBS), np.tanh(rs.randn(ACT)), rs.rand(), 0.0,
                  rs.randn(STATE_OBS)) for _ in range(n)]
        rows = {k: np.asarray(col, np.float32) for k, col in zip(ROW_KEYS, zip(*draws))}
        buf = state_buffer(rows, self.device)
        idx = rs.randint(0, n, (STATE_STEPS, b))
        m, models = {}, []
        for algo, cls, seed in (("iql", IQLTrainer, 1), ("cql", CQLTrainer, 2)):
            tr = rl_trainer(cls, self.device, self.group, STATE_OBS, STATE_OBS, seed)
            ref = rl_trainer(cls, self.device, None, STATE_OBS, STATE_OBS, seed)
            steps = ([cql_draws(rs, b, tr.num_random) for _ in range(STATE_STEPS)]
                     if cls is CQLTrainer else None)
            mine = None if steps is None else [
                {k: rank_rows(v, self.rank, self.world) for k, v in d.items()} for d in steps]
            got = train_many_dp(tr, self.mesh, STATE_STEPS, b, buffer=buf,
                                indices=idx[:, self.rank * ROWS:(self.rank + 1) * ROWS],
                                draws=mine)
            train_many(ref, STATE_STEPS, b, buf, indices=idx, draws=steps)
            m[f"critic_{algo}"] = finite(f"scanned {algo}", got, ("critic_loss",))["critic_loss"]
            m[f"err_{algo}"] = err = max_param_diff(trained(tr), trained(ref))
            if not err <= STATE_TOL:
                raise RuntimeError(f"scanned {algo}: the parameters are {err} from one "
                                   "process's train_many on the global batches")
            models += trained(tr)
        return m, (f"scanned IQL/CQL ok  critic_iql={m['critic_iql']:.4f} "
                   f"critic_cql={m['critic_cql']:.4f} vs one process max|Δ|="
                   f"{max(m['err_iql'], m['err_cql']):.2e} (batch sharded, buffer on every "
                   "rank)"), models

    def image_rl(self) -> Tuple[Dict[str, float], str, list]:
        real = slac_pool(self.device, self.group, self.world, 7, 3, 6, 64)
        gen = slac_pool(self.device, self.group, self.world, 8, 3, 6, 64)
        m, models = {}, []
        for algo, cls, seed in (("iql", IQLTrainer, 3), ("cql", CQLTrainer, 4)):
            tr = rl_trainer(cls, self.device, self.group, real.z_dim, real.feature_action_dim,
                            seed, slac_algo=real)
            got = train_many_dp(tr, self.mesh, IMAGE_STEPS, image_batch(self.world),
                                buffer_gen=gen.buffer)
            vals = finite(f"image {algo}", got, ("critic_loss", "loss_kld"))
            m.update({f"{k}_{algo}": v for k, v in vals.items()})
            models += trained(tr)
        return m, (f"scanned IMAGE-RL ok  critic_iql={m['critic_loss_iql']:.4f} "
                   f"critic_cql={m['critic_loss_cql']:.4f} "
                   "(frame pools on every rank, joint latent, dual-buffer)"), models

    def tp(self) -> Tuple[Dict[str, float], str, list]:
        tp_mesh = make_mesh(MeshSpec(data=self.world // 2, model=2))
        gen = S2PGenerator(STATE_DIM, seed=1, device=self.device, **TP_G)
        rs, b = self.rs, self.b
        s = rs.randn(b, STATE_DIM).astype(np.float32)
        img = (rs.rand(b, 32, 32, 3) * 2 - 1).astype(np.float32)
        with torch.no_grad():
            ref = gen(torch.as_tensor(s, device=self.device),
                      torch.as_tensor(img, device=self.device)).cpu()
        res = sharded_forward(tp_mesh, copy.deepcopy(gen), TP_MIN_FEATURES, s, img)
        err = (res["out"] - ref).abs().max().item()
        if not res["sharded"] or not err < TP_TOL:
            raise RuntimeError(f"TP forward mismatch: {err} over {len(res['sharded'])} "
                               "sharded layers")
        shape = {"data": self.world // 2, "model": 2}
        return (dict(max_abs_err=err, sharded=len(res["sharded"])),
                f"TP generator ok  mesh={shape} max|Δ|={err:.2e}", [])


def run(rank: int, world: int, init_method: str, device_type: str, out_dir: str) -> None:
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    # f32 convolutions and products (no TF32), for the TP leg's 1e-4 bound
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = ranks_backend([rank_device(r, device_type) for r in range(world)])
    initialize_distributed(init_method, world, rank, backend=backend, device=device)
    mesh = make_mesh(MeshSpec(data=world))
    legs = Legs(mesh, device, world)
    devices = sorted({str(rank_device(r, device_type)) for r in range(world)})
    where = f"{backend}; {world} ranks on {', '.join(devices)}"
    records, lines = [], []
    for name in leg_names(world):
        counters = (cuda_kernels.fused_mat_norm, cuda_kernels.fused_mat_norm_bwd)
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        metrics, text, models = getattr(legs, name)()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        launches = tuple(c.launches - b for c, b in zip(counters, before))
        records.append(dict(name=name, seconds=seconds, metrics=metrics, launches=launches,
                            digest=params_digest(*models) if models else None))
        if rank == 0:
            line = f"dryrun_multichip({world}): {text}  [{seconds:.2f} s; {where}]"
            print(line, flush=True)
            lines.append(line)
    torch.save(dict(rank=rank, device=str(device), backend=backend, legs=records, lines=lines),
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
