"""S2P GAN training: alternating D and G updates.

The port of ``s2p_tpu/gan/training.py``. One ``train_step`` runs the D
update and then the G update, as ``GANTrainer._update`` does: hinge
adversarial + feature matching + L1 + VGG perceptual losses, TTUR Adam
(β = (0, 0.999)), lazy R1 keyed to performed D updates, and an optional
D cadence (``d_every``). Batches enter as uint8 and are normalised to
[-1, 1] on the device.

Mixed precision mirrors the JAX package's ``cast``: parameters and the
optimiser state stay float32; each forward runs on ``compute_dtype``
copies of them through ``torch.func.functional_call``, so the gradients
land on the float32 parameters; losses are taken in float32, and the
perceptual loss sees float32 images and float32 VGG weights.

After a step, each parameter's ``.grad`` holds the gradient that step
applied.

Data parallelism: JAX averages gradients and metrics over the mesh's data
axis with ``pmean`` inside the step. The port runs one process per card,
so a trainer given ``dp_group`` (the mesh's data group) averages them
explicitly: one all-reduce of one flat float32 buffer per module per
update, after the gradient and before the optimizer step, and one of the
stacked step metrics. Each rank trains on its part of the global batch;
since every loss is a mean over equal-size parts, the averaged step is the
step on the global batch. ``DistributedDataParallel`` is not used: D runs
twice before its gradient is taken and again inside G's loss, and R1 takes
``autograd.grad(..., create_graph=True)`` through it, which DDP's reducer
does not support.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.func import functional_call

from s2p_tpu_torch.gan.discriminator import MultiscaleDiscriminator
from s2p_tpu_torch.gan.generator import S2PGenerator
from s2p_tpu_torch.gan.losses import (
    GANLossConfig,
    feature_matching_loss,
    hinge_d_loss,
    hinge_g_loss,
    l1_loss,
    logits_of,
    r1_penalty,
)
from s2p_tpu_torch.gan.perceptual import PerceptualLoss
from s2p_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, all_reduce_mean, shard_batch

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GANOptConfig:
    """SPADE-style TTUR defaults (G slower than D)."""

    g_lr: float = 1e-4
    d_lr: float = 4e-4
    beta1: float = 0.0
    beta2: float = 0.999


def _to_signed(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [-1, 1] → float32 [-1, 1]."""
    if img.dtype == torch.uint8:
        return img.float() / 127.5 - 1.0
    return img.float()


def _adam(module: nn.Module, lr: float, cfg: GANOptConfig) -> torch.optim.Adam:
    """``optax.adam``: m̂ / (√v̂ + ε) with ε = 1e-8."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)


def _f32(feats):
    return [[f.float() for f in fs] for fs in feats]


class GANTrainer:
    """Owns G, D, their optimisers and the perceptual loss; ``g_step`` and
    ``d_step`` count performed G and D updates. With ``dp_group`` (a
    process group; None in a single process) gradients and metrics are
    averaged over its ranks."""

    def __init__(self, generator: S2PGenerator, discriminator: MultiscaleDiscriminator,
                 perceptual: Optional[PerceptualLoss],
                 loss_cfg: GANLossConfig = GANLossConfig(),
                 opt_cfg: GANOptConfig = GANOptConfig(),
                 compute_dtype: torch.dtype = torch.float32, d_every: int = 1,
                 dp_group: Optional[dist.ProcessGroup] = None):
        self.generator, self.discriminator, self.perceptual = generator, discriminator, perceptual
        self.loss_cfg = loss_cfg
        self.compute_dtype = compute_dtype
        # update D only every k-th step (G updates every step); 1 = reference
        self.d_every = max(int(d_every), 1)
        self.g_opt = _adam(generator, opt_cfg.g_lr, opt_cfg)
        self.d_opt = _adam(discriminator, opt_cfg.d_lr, opt_cfg)
        self.g_step = self.d_step = 0
        self.dp_group = dp_group
        self._dp_data = None  # (host dataset, this rank's staged shard) of train_many_dp

    @classmethod
    def create(cls, state_dim: int, image_size: int = 64, channels: int = 3,
               generator_kwargs: Optional[Dict[str, Any]] = None,
               discriminator_kwargs: Optional[Dict[str, Any]] = None,
               opt_cfg: GANOptConfig = GANOptConfig(),
               loss_cfg: GANLossConfig = GANLossConfig(), use_perceptual: bool = True,
               vgg_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
               compute_dtype: torch.dtype = torch.float32, d_every: int = 1, seed: int = 0,
               device: str | torch.device = "cuda",
               dp_group: Optional[dist.ProcessGroup] = None) -> "GANTrainer":
        """G, D and the VGG19 of the perceptual loss from seeds ``seed``,
        ``seed + 1`` and ``seed + 2``, on ``device`` (the card unless the
        caller asks otherwise)."""
        gen = S2PGenerator(state_dim, image_size=image_size, out_channels=channels,
                           seed=seed, device=device, **(generator_kwargs or {}))
        disc = MultiscaleDiscriminator(state_dim, channels, seed=seed + 1, device=device,
                                       **(discriminator_kwargs or {}))
        perceptual = (PerceptualLoss(vgg_state_dict, seed=seed + 2, device=device)
                      if use_perceptual else None)
        return cls(gen, disc, perceptual, loss_cfg, opt_cfg, compute_dtype, d_every, dp_group)

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device

    def _params(self, module: nn.Module, grad: bool) -> Dict[str, torch.Tensor]:
        """``compute_dtype`` copies of the module's parameters (no copy in
        float32); differentiable into the float32 ones when ``grad``."""
        return {k: (p if grad else p.detach()).to(self.compute_dtype)
                for k, p in module.named_parameters()}

    def _apply(self, opt: torch.optim.Optimizer, module: nn.Module, loss: torch.Tensor) -> None:
        """Gradient of ``loss`` over ``module``'s parameters only (zeros for
        one it does not reach), averaged over the data-parallel ranks, set
        as their ``.grad``, then one step."""
        params = list(module.parameters())
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        self.sync_grads(grads)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()

    def sync_grads(self, grads) -> None:
        """Average ``grads`` in place over the data-parallel ranks (one flat
        all-reduce and the copies back); nothing without a group."""
        if self.dp_group is not None:
            for g, mean in zip(grads, all_reduce_mean(grads, self.dp_group)):
                g.copy_(mean)

    def _d_update(self, state, prev, real):
        G, D, cfg = self.generator, self.discriminator, self.loss_cfg
        with torch.no_grad():
            fake = functional_call(G, self._params(G, grad=False), (state, prev))
        d_params = self._params(D, grad=True)
        # lazy R1 keys off performed D updates: with d_every > 1 it still
        # fires every r1_interval-th D update, matching its interval scaling
        r1_interval = max(int(cfg.r1_interval), 1)
        do_r1 = cfg.r1_gamma > 0.0 and self.d_step % r1_interval == 0
        real_in = real.detach().requires_grad_(do_r1)
        rf = logits_of(functional_call(D, d_params, (state, prev, real_in)))
        ff = logits_of(functional_call(D, d_params, (state, prev, fake)))
        loss = hinge_d_loss([x.float() for x in rf], [x.float() for x in ff])
        r1 = torch.zeros((), device=real.device)
        if do_r1:
            # per-sample mean over patch logits, averaged over scales and
            # summed over the batch, so grad(img) is each sample's own
            per_sample = sum(x.float().mean(dim=tuple(range(1, x.dim()))) for x in rf) / len(rf)
            (grad_real,) = torch.autograd.grad(per_sample.sum(), real_in, create_graph=True)
            r1 = r1_penalty(grad_real)
            loss = loss + (0.5 * cfg.r1_gamma * r1_interval) * r1
        self._apply(self.d_opt, D, loss)
        self.d_step += 1
        return loss.detach(), r1.detach()

    def _g_update(self, state, prev, real):
        G, D, cfg = self.generator, self.discriminator, self.loss_cfg
        fake = functional_call(G, self._params(G, grad=True), (state, prev))
        d_params = self._params(D, grad=False)  # D's post-update parameters
        ff = functional_call(D, d_params, (state, prev, fake))
        with torch.no_grad():  # real features: detached in the loss
            rf = functional_call(D, d_params, (state, prev, real))
        adv = hinge_g_loss([x.float() for x in logits_of(ff)])
        fm = feature_matching_loss(_f32(rf), _f32(ff))
        l1 = l1_loss(fake.float(), real.float())
        loss = cfg.lambda_gan * adv + cfg.lambda_feat * fm + cfg.lambda_l1 * l1
        vgg = torch.zeros((), device=real.device)
        if self.perceptual is not None:
            vgg = self.perceptual(fake.float(), real.float())
            loss = loss + cfg.lambda_vgg * vgg
        self._apply(self.g_opt, G, loss)
        self.g_step += 1
        aux = dict(g_adv=adv, g_fm=fm, g_l1=l1, g_vgg=vgg)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def train_step(self, batch: Mapping[str, Any]) -> Metrics:
        """One D update (every ``d_every``-th step) and one G update on a
        batch of ``prev_image``/``target_image`` (uint8 or [-1, 1] NHWC) and
        ``state``; returns the step's metrics as 0-d device tensors. Under
        data parallelism the batch is this rank's part of the global batch,
        and the metrics are averaged over the ranks."""
        dev, dt = self.device, self.compute_dtype
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        prev = _to_signed(batch["prev_image"]).to(dt)
        real = _to_signed(batch["target_image"]).to(dt)
        state = batch["state"].float().to(dt)
        d_loss = d_r1 = torch.zeros((), device=dev)
        if self.g_step % self.d_every == 0:
            d_loss, d_r1 = self._d_update(state, prev, real)
        g_loss, aux = self._g_update(state, prev, real)
        metrics = dict(d_loss=d_loss, g_loss=g_loss, **aux)
        if self.loss_cfg.r1_gamma > 0.0:
            metrics["d_r1"] = d_r1
        if self.dp_group is not None:
            metrics = dict(zip(metrics, all_reduce_mean(list(metrics.values()), self.dp_group)))
        return metrics

    def train_many(self, data: Mapping[str, torch.Tensor], num_steps: int, batch_size: int,
                   generator: Optional[torch.Generator] = None,
                   indices: Optional[Any] = None) -> Metrics:
        """``num_steps`` updates on batches drawn uniformly with replacement
        from ``data`` (device-resident uint8 frames and states, the keys of
        a ``train_step`` batch) with ``generator`` on the data's device, or
        taken from ``indices`` ([num_steps, batch_size] rows of ``data``);
        returns the metrics averaged over the steps."""
        n, dev = data["state"].shape[0], data["state"].device
        sums: Metrics = {}
        for step in range(num_steps):
            idx = (torch.randint(0, n, (batch_size,), generator=generator, device=dev)
                   if indices is None else torch.as_tensor(indices[step], device=dev))
            metrics = self.train_step({k: v.index_select(0, idx) for k, v in data.items()})
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        return {k: v / num_steps for k, v in sums.items()}

    def train_many_dp(self, mesh: Mesh, data: Mapping[str, Any], num_steps: int,
                      batch_size: int, generator: Optional[torch.Generator] = None,
                      indices: Optional[Any] = None) -> Metrics:
        """``num_steps`` updates data-parallel over ``mesh``'s data axis, laid
        out as the JAX package's ``train_many_dp`` lays them out.

        ``data`` is the whole dataset on the host, the same on every rank.
        Of its first n rows (trailing rows beyond a multiple of the axis
        size d dropped), rank r stages only its contiguous shard [r·n/d,
        (r+1)·n/d) on its device (once per ``data`` object), and each step
        samples ``batch_size``/d rows of that shard with ``generator``, which
        the caller seeds per (seed, rank) as JAX folds the axis index into
        the key, or takes them from ``indices`` ([num_steps, batch_size/d]
        rows of the shard). ``batch_size`` is the global batch. So with a
        dataset that concatenates two envs in equal halves, on 2 ranks rank
        0 samples only the first env's rows and rank 1 only the second's,
        and the averaged gradient mixes them.

        Returns the metrics averaged over the steps and the ranks.
        """
        d = mesh.shape[DATA_AXIS]
        if batch_size % d:
            raise ValueError(f"global batch {batch_size} does not divide over {d} data ranks")
        if self.dp_group is not mesh.groups[DATA_AXIS]:
            raise ValueError("the trainer's dp_group is not the mesh's data group")
        if self._dp_data is None or self._dp_data[0] is not data:
            n = len(data["state"]) - len(data["state"]) % d
            shard = shard_batch(mesh, {k: v[:n] for k, v in data.items()})
            self._dp_data = (data, {k: torch.as_tensor(v, device=self.device)
                                    for k, v in shard.items()})
        return self.train_many(self._dp_data[1], num_steps, batch_size // d, generator, indices)

    @torch.no_grad()
    def generate(self, state: torch.Tensor, prev_image: torch.Tensor) -> torch.Tensor:
        """G's float32 forward: [B, S] states, [B, H, W, C] images in [-1, 1]."""
        return self.generator(state, prev_image)

    def state_dict(self) -> Dict[str, Any]:
        return dict(g=self.generator.state_dict(), g_opt=self.g_opt.state_dict(),
                    d=self.discriminator.state_dict(), d_opt=self.d_opt.state_dict(),
                    g_step=self.g_step, d_step=self.d_step)

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.generator.load_state_dict(state["g"])
        self.discriminator.load_state_dict(state["d"])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])
        self.g_step, self.d_step = int(state["g_step"]), int(state["d_step"])
