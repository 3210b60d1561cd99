"""GAN losses: hinge adversarial, feature matching, L1, R1.

The port of ``s2p_tpu/gan/losses.py``. Every term is a plain reduction over
the discriminator's outputs (a list per scale of the feature maps, the
patch logits last); ``stop_gradient`` becomes ``.detach()``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class GANLossConfig:
    lambda_l1: float = 10.0
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    lambda_gan: float = 1.0
    # R1 gradient penalty on real images (StyleGAN2 convention): adds
    # (r1_gamma/2)·E[||∇_x D(x)||²] to the D loss; 0 disables. With
    # r1_interval > 1 it is applied lazily every k-th D update, scaled by k.
    r1_gamma: float = 0.0
    r1_interval: int = 16


def r1_penalty(grad_real: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the squared norm of D's real-logit gradient
    with respect to the real image."""
    g = grad_real.float()
    return g.square().sum(dim=tuple(range(1, g.dim()))).mean()


def hinge_d_loss(real_logits: List[torch.Tensor],
                 fake_logits: List[torch.Tensor]) -> torch.Tensor:
    """Mean over scales of E[relu(1 − D(real))] + E[relu(1 + D(fake))]."""
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        loss = loss + F.relu(1.0 - r).mean() + F.relu(1.0 + f).mean()
    return loss / len(real_logits)


def hinge_g_loss(fake_logits: List[torch.Tensor]) -> torch.Tensor:
    """Mean over scales of −E[D(fake)]."""
    loss = 0.0
    for f in fake_logits:
        loss = loss - f.mean()
    return loss / len(fake_logits)


def feature_matching_loss(real_feats: List[List[torch.Tensor]],
                          fake_feats: List[List[torch.Tensor]]) -> torch.Tensor:
    """L1 between D's intermediate features on real and fake, averaged over
    layers and scales (pix2pixHD convention; the logits are excluded)."""
    loss = 0.0
    for rs, fs in zip(real_feats, fake_feats):
        n_layers = len(rs) - 1  # the last entry is the logit map
        for r, f in zip(rs[:-1], fs[:-1]):
            loss = loss + (f - r.detach()).abs().mean() / n_layers
    return loss / len(real_feats)


def l1_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return (fake - real).abs().mean()


def logits_of(disc_feats: List[List[torch.Tensor]]) -> List[torch.Tensor]:
    return [fs[-1] for fs in disc_feats]
