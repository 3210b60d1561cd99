"""GAN training: ``GANTrainer.train_step(batch)`` on host batches in a closed
loop, as ``cli/train_gan.py`` runs it (one step a call).

Traffic: a host pool of ``pool_rows`` uint8 (previous, target) frame pairs
and float32 states drawn from the seed on the device in set-up; batches of
``batch`` rows taken in the order of a permutation drawn from the seed.
Set-up drives the trainer through its first ``checked_steps`` steps, with
the same call and feed as the window, and keeps what the comparison needs:
each step's losses, the first gradient (Adam's first moment after one step:
β1 is 0) and the parameters' change. The window continues from there.
"""

from __future__ import annotations

import torch

from portbench import compare, harness, program
from portbench.reference import nets
from portbench.reference.precision import Precision


class Train:
    latency = False

    def __init__(self, ctx: harness.Ctx):
        from s2p_tpu_torch.gan import GANLossConfig, GANOptConfig, GANTrainer

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        t, d, lam = cfg["training"], cfg["discriminator"], cfg["training"]["lambda"]
        self.ctx = ctx
        self.trainer = GANTrainer.create(
            cfg["state_dim"], image_size=cfg["image_size"], channels=cfg["out_channels"],
            generator_kwargs={k: v for k, v in program.generator_kwargs(cfg).items()
                              if k not in ("image_size", "out_channels")},
            discriminator_kwargs=dict(ndf=d["ndf"], num_scales=d["num_scales"],
                                      n_layers=d["n_layers"]),
            opt_cfg=GANOptConfig(g_lr=t["g_lr"], d_lr=t["d_lr"], beta1=t["beta1"],
                                 beta2=t["beta2"]),
            loss_cfg=GANLossConfig(lambda_l1=lam["l1"], lambda_feat=lam["feat"],
                                   lambda_vgg=lam["vgg"], lambda_gan=lam["gan"],
                                   r1_gamma=t["r1_gamma"], r1_interval=t["r1_interval"]),
            use_perceptual=True, compute_dtype=program.DTYPE[cfg["precision"]], device=dev)
        g = ctx.generator("weights")
        self.weights = {m: harness.seeded_weights(spec, g, dev) for m, spec in (
            ("G", nets.generator_spec(cfg)), ("D", nets.discriminator_spec(cfg)),
            ("VGG", nets.vgg19_spec()))}
        self.modules = {"G": self.trainer.generator, "D": self.trainer.discriminator}
        for m, module in (*self.modules.items(), ("VGG", self.trainer.perceptual.vgg)):
            module.load_state_dict(self.weights[m], strict=True)
        N, H, C = tr["pool_rows"], cfg["image_size"], cfg["out_channels"]
        g = ctx.generator("traffic")
        pool = lambda: torch.randint(0, 256, (N, H, H, C), generator=g, device=dev,
                                     dtype=torch.uint8).cpu().numpy()
        self.prev, self.target = pool(), pool()
        self.states = torch.randn(N, cfg["state_dim"], generator=g, device=dev).cpu().numpy()
        self.order = torch.randperm(N, generator=g, device=dev).cpu().numpy()
        self.steps_done = 0
        self.checked = self._checked_steps(tr["checked_steps"])

    def batch(self, i: int) -> dict:
        b = self.ctx.traffic["batch"]
        lo = i * b % len(self.order)
        idx = self.order[lo:lo + b]
        return dict(prev_image=self.prev[idx], state=self.states[idx],
                    target_image=self.target[idx])

    def step(self) -> dict:
        with self.ctx.span("train.batch"):
            batch = self.batch(self.steps_done)
        metrics = self.trainer.train_step(batch)
        self.steps_done += 1
        return metrics

    def _checked_steps(self, n: int) -> dict:
        start = {m: {k: p.detach().clone() for k, p in mod.named_parameters()}
                 for m, mod in self.modules.items()}
        opts = {"G": self.trainer.g_opt, "D": self.trainer.d_opt}
        batches, losses, grads = [], [], None
        for i in range(n):
            batches.append(self.batch(self.steps_done))
            metrics = self.step()
            losses.append({k: v.item() for k, v in metrics.items()})
            if i == 0:
                # an optimizer that took no step holds no moment: nothing reached it
                grads = {m: compare.norms({k: opts[m].state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) for k, p in mod.named_parameters()})
                         for m, mod in self.modules.items()}
        change = {m: compare.norms({k: p.detach() - start[m][k]
                                    for k, p in mod.named_parameters()})
                  for m, mod in self.modules.items()}
        return dict(batches=batches, readings=dict(losses=losses, grads=grads, change=change))

    def call(self, i: int) -> dict:
        self.step()
        return {"steps": 1}

    def finish(self) -> dict:
        judged = dict(self.checked, weights=self.weights)
        del self.trainer, self.modules
        return judged


def setup(ctx):
    return Train(ctx)


def check(ctx, judged, report=None) -> dict:
    ref = compare.reference_training(ctx.config, judged["weights"], judged["batches"],
                                     Precision("f32"), ctx.device)
    return compare.train_gaps(judged["readings"], ref, report)


def control(ctx, judged, kind: str, report=None) -> dict:
    """Readings with a control in the program's place: the reference in
    ``kind`` precision, or (``half_batch``) the float32 reference that
    leaves out half of each batch."""
    batches = judged["batches"]
    if kind == "half_batch":
        batches = [{k: v[: len(v) // 2] for k, v in b.items()} for b in batches]
    prec = Precision("f32" if kind == "half_batch" else kind)
    fake = compare.reference_training(ctx.config, judged["weights"], batches, prec, ctx.device)
    return check(ctx, dict(judged, readings=fake), report)
