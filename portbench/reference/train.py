"""The S2P GAN training step written from the protocol in plain PyTorch.

One step is a D update and then a G update on one batch:

- D: hinge loss on (real, G(state, prev)) at every scale, averaged over
  scales; every ``r1_interval``-th D update (the first included) adds
  (γ/2)·interval·R1, R1 being the batch mean of the squared norm of the
  gradient of each sample's real logits (mean over patches, averaged over
  scales) with respect to the real image.
- G: λ_gan·(−mean fake logits) + λ_feat·feature matching (L1 of D's
  features, logits excluded, averaged over layers and scales) + λ_l1·L1 +
  λ_vgg·VGG19 loss, against the D just updated.
- Adam (ε 1e-8, bias-corrected), TTUR rates and β from the configuration.

Parameters and Adam's state stay float32; G, D and VGG19 compute in
``prec``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference import nets
from portbench.reference.precision import Precision


def to_signed(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] → float32 [-1, 1]."""
    return img.float() / 127.5 - 1.0


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas, eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps, self.t = params, lr, betas, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / (1 - b2 ** self.t) ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))


def _hinge_d(rf: List[torch.Tensor], ff: List[torch.Tensor]) -> torch.Tensor:
    return sum(F.relu(1 - r).mean() + F.relu(1 + f).mean() for r, f in zip(rf, ff)) / len(rf)


def _feature_matching(real, fake) -> torch.Tensor:
    total = 0.0
    for rs, fs in zip(real, fake):
        n = len(rs) - 1
        total = total + sum((f - r.detach()).abs().mean() for r, f in zip(rs[:-1], fs[:-1])) / n
    return total / len(real)


def _float(feats):
    return [[f.float() for f in fs] for fs in feats]


def train_steps(cfg, weights: Dict[str, Dict[str, torch.Tensor]], batches: List[dict],
                prec: Precision) -> dict:
    """Run ``len(batches)`` steps from ``weights`` ({"G", "D", "VGG"}: float32
    tensors, copied) on host batches (uint8 ``prev_image``/``target_image``,
    float32 ``state``). Returns each step's losses (``d_loss``, ``g_loss``
    and their terms, named as the port's trainer names them), the first
    step's gradients and the parameters after the last step, per module."""
    tr = cfg["training"]
    G = {k: v.detach().clone().float().requires_grad_() for k, v in weights["G"].items()}
    D = {k: v.detach().clone().float().requires_grad_() for k, v in weights["D"].items()}
    V = prec.cast(weights["VGG"])
    g_opt = Adam(G, tr["g_lr"], (tr["beta1"], tr["beta2"]))
    d_opt = Adam(D, tr["d_lr"], (tr["beta1"], tr["beta2"]))
    lam = tr["lambda"]
    interval, gamma = tr["r1_interval"], tr["r1_gamma"]
    dev = next(iter(G.values())).device
    losses, first_grads = [], None
    for step, batch in enumerate(batches):
        prev = to_signed(torch.as_tensor(batch["prev_image"], device=dev)).to(prec.dtype)
        real = to_signed(torch.as_tensor(batch["target_image"], device=dev)).to(prec.dtype)
        state = torch.as_tensor(batch["state"], device=dev).float().to(prec.dtype)
        # D update
        with torch.no_grad():
            fake = nets.generator(prec.cast(G), cfg, state, prev, prec)
        do_r1 = gamma > 0 and step % interval == 0
        real_in = real.detach().requires_grad_(do_r1)
        Dc = prec.cast(D)
        rf = [fs[-1] for fs in nets.discriminator(Dc, cfg, state, prev, real_in, prec)]
        ff = [fs[-1] for fs in nets.discriminator(Dc, cfg, state, prev, fake, prec)]
        d_loss = _hinge_d([x.float() for x in rf], [x.float() for x in ff])
        r1 = torch.zeros(())
        if do_r1:
            per_sample = sum(x.float().mean(dim=(1, 2, 3)) for x in rf) / len(rf)
            (g_real,) = torch.autograd.grad(per_sample.sum(), real_in, create_graph=True)
            r1 = g_real.float().square().sum(dim=(1, 2, 3)).mean()
            d_loss = d_loss + (0.5 * gamma * interval) * r1
        d_grads = dict(zip(D, torch.autograd.grad(d_loss, list(D.values()))))
        d_opt.step(d_grads)
        # G update
        fake = nets.generator(prec.cast(G), cfg, state, prev, prec)
        Dd = prec.cast({k: v.detach() for k, v in D.items()})
        ff = nets.discriminator(Dd, cfg, state, prev, fake, prec)
        with torch.no_grad():
            rf = nets.discriminator(Dd, cfg, state, prev, real, prec)
        adv = -sum(f[-1].float().mean() for f in ff) / len(ff)
        fm = _feature_matching(_float(rf), _float(ff))
        l1 = (fake.float() - real.float()).abs().mean()
        vgg = nets.vgg19_loss(V, fake, real, prec)
        g_loss = (lam["gan"] * adv + lam["feat"] * fm + lam["l1"] * l1
                  + lam["vgg"] * vgg.float())
        g_grads = dict(zip(G, torch.autograd.grad(g_loss, list(G.values()))))
        g_opt.step(g_grads)
        losses.append({k: v.item() for k, v in dict(
            d_loss=d_loss, d_r1=r1, g_loss=g_loss, g_adv=adv, g_fm=fm, g_l1=l1, g_vgg=vgg).items()})
        if step == 0:
            first_grads = {"G": {k: v.detach() for k, v in g_grads.items()},
                           "D": {k: v.detach() for k, v in d_grads.items()}}
    return dict(losses=losses, grads=first_grads,
                params={"G": {k: v.detach() for k, v in G.items()},
                        "D": {k: v.detach() for k, v in D.items()}})
