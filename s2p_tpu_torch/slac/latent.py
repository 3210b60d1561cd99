"""SLAC sequential latent-variable model.

The port of ``s2p_tpu/slac/latent.py``:

- factorized latent z = (z1 ‖ z2), z1 32 and z2 256 wide; priors and
  posteriors are (256, 256) LeakyReLU(0.2) MLP Gaussian heads with
  ``softplus(std) + 1e-5``, xavier-uniform kernels, zero biases;
- q(z2|·) ≡ p(z2|·) and q(z2(0)|z1(0)) ≡ p(z2(0)|z1(0)): one module each,
  registered under both names as in the reference (``z2_posterior_init``
  and ``z2_posterior`` are the ``z2_prior_init`` and ``z2_prior``
  modules), so the reference's ``latent.pth`` loads with ``strict=True``;
- the conv encoder and the deconv decoder with the exact 64px and 100px
  chains, LeakyReLU(0.2) after every conv and every deconv, the last ones
  included (the decoder's mean passes through it), decoder std √0.1;
- the reward head p(r | z(t), a(t), z(t+1));
- ELBO = KL(post ‖ prior on z1) + image NLL + (1 − done)-masked reward NLL,
  each ``.mean(0).sum()`` over ``[B, S(+1), …]``.

Module names follow the reference torch checkpoint: ``{head}.net.{0,2,4}``,
``encoder.net.{0,2,…}``, ``decoder.net.{0,2,…}`` (activations in the odd
``Sequential`` slots). Images are NHWC floats in [0, 1] at the API; the
convs run NCHW on a channels-last view. The posterior's 2·(S+1) standard
normals come from a ``torch.Generator`` or are given as a list, in the
JAX package's order: z1 then z2, at t = 0 … S.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.nn.initializers import xavier_uniform_
from s2p_tpu_torch.nn.mlp import init_generator

Noise = Union[None, torch.Generator, Sequence[torch.Tensor]]

_ENCODER_CFG = {
    # (out_ch, kernel, stride, padding) per conv
    64: [(32, 5, 2, 2), (64, 3, 2, 1), (128, 3, 2, 1), (256, 3, 2, 1), (None, 4, 1, 0)],
    100: [(32, 5, 2, 2), (64, 3, 2, 1), (128, 3, 2, 1), (256, 3, 2, 1), (256, 3, 2, 1),
          (None, 4, 1, 0)],
}

_DECODER_CFG = {
    # (out_ch, kernel, stride, padding, output_padding) per deconv
    64: [(256, 4, 1, 0, 0), (128, 3, 2, 1, 1), (64, 3, 2, 1, 1), (32, 3, 2, 1, 1),
         (None, 5, 2, 2, 1)],
    100: [(256, 4, 1, 0, 0), (256, 3, 2, 1, 0), (128, 3, 2, 1, 0), (64, 3, 2, 1, 0),
          (32, 3, 2, 1, 1), (None, 5, 2, 2, 1)],
}


def _init_xavier_(module: nn.Module, gen: torch.Generator) -> None:
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            nn.init.zeros_(p)
        else:
            xavier_uniform_(p, gen)


def _chain(layers: List[nn.Module]) -> nn.Sequential:
    """Each layer followed by LeakyReLU(0.2): layers at even indices."""
    seq = []
    for layer in layers:
        seq += [layer, nn.LeakyReLU(0.2)]
    return nn.Sequential(*seq)


class FixedGaussianParams:
    """p(z1(0)) = N(0, std²·I)."""

    def __init__(self, dim: int, std: float) -> None:
        self.dim, self.std = dim, std

    def __call__(self, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = like.shape[0]
        return (like.new_zeros(b, self.dim), like.new_full((b, self.dim), self.std))


class GaussianHead(nn.Module):
    """MLP → (mean, softplus(std) + 1e-5)."""

    def __init__(self, input_dim: int, output_dim: int,
                 hidden_units: Sequence[int] = (256, 256)):
        super().__init__()
        widths = [input_dim, *hidden_units]
        layers: List[nn.Module] = []
        for i, o in zip(widths[:-1], widths[1:]):
            layers += [nn.Linear(i, o), nn.LeakyReLU(0.2)]
        layers.append(nn.Linear(widths[-1], 2 * output_dim))
        self.net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, std = self.net(x).chunk(2, dim=-1)
        return mean, F.softplus(std) + 1e-5


class SlacEncoder(nn.Module):
    """[B, S, H, W, C] in [0, 1] → features [B, S, feature_dim]."""

    def __init__(self, feature_dim: int = 256, image_size: int = 64, channels: int = 3):
        super().__init__()
        convs, c_prev = [], channels
        for c, k, s, p in _ENCODER_CFG[image_size]:
            c = c if c is not None else feature_dim
            convs.append(nn.Conv2d(c_prev, c, k, stride=s, padding=p))
            c_prev = c
        self.net = _chain(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape[:2]
        h = x.reshape((B * S,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)
        return self.net(h).reshape(B, S, -1)


class SlacDecoder(nn.Module):
    """z [B, S, z_dim] → (mean [B, S, H, W, C], std = √0.1 everywhere)."""

    def __init__(self, input_dim: int, out_channels: int = 3, std: float = math.sqrt(0.1),
                 image_size: int = 64):
        super().__init__()
        self.std = std
        deconvs, c_prev = [], input_dim
        for c, k, s, p, op in _DECODER_CFG[image_size]:
            c = c if c is not None else out_channels
            deconvs.append(nn.ConvTranspose2d(c_prev, c, k, stride=s, padding=p,
                                              output_padding=op))
            c_prev = c
        self.net = _chain(deconvs)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, D = z.shape
        h = self.net(z.reshape(B * S, D, 1, 1)).permute(0, 2, 3, 1)
        h = h.reshape((B, S) + tuple(h.shape[1:]))
        return h, torch.full_like(h, self.std)


def calculate_kl_divergence(p_mean: torch.Tensor, p_std: torch.Tensor, q_mean: torch.Tensor,
                            q_std: torch.Tensor) -> torch.Tensor:
    """Elementwise KL(N(p) ‖ N(q))."""
    var_ratio = (p_std / q_std) ** 2
    t1 = ((p_mean - q_mean) / q_std) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def create_feature_actions(feature_: torch.Tensor, action_: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fa(t), fa(t+1)): the flattened feature and action windows."""
    N = feature_.shape[0]
    f = feature_[:, :-1].reshape(N, -1)
    n_f = feature_[:, 1:].reshape(N, -1)
    a = action_[:, :-1].reshape(N, -1)
    n_a = action_[:, 1:].reshape(N, -1)
    return torch.cat([f, a], dim=-1), torch.cat([n_f, n_a], dim=-1)


def gaussian_nll(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Elementwise −log N(x; mean, std²), with the 1e-8 of the reference."""
    noise = (x - mean) / (std + 1e-8)
    return -((-0.5 * noise ** 2 - torch.log(std)) - 0.5 * math.log(2 * math.pi))


class LatentModel(nn.Module):
    """Sequential VAE over (num_sequences + 1)-frame windows."""

    def __init__(self, action_dim: int, feature_dim: int = 256, z1_dim: int = 32,
                 z2_dim: int = 256, hidden_units: Sequence[int] = (256, 256),
                 image_size: int = 64, channels: int = 3,
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        hu = tuple(hidden_units)
        self.z1_dim, self.z2_dim = z1_dim, z2_dim
        self.z1_prior_init = FixedGaussianParams(z1_dim, 1.0)
        self.z2_prior_init = GaussianHead(z1_dim, z2_dim, hu)
        self.z1_prior = GaussianHead(z2_dim + action_dim, z1_dim, hu)
        self.z2_prior = GaussianHead(z1_dim + z2_dim + action_dim, z2_dim, hu)
        self.z1_posterior_init = GaussianHead(feature_dim, z1_dim, hu)
        self.z1_posterior = GaussianHead(feature_dim + z2_dim + action_dim, z1_dim, hu)
        self.z2_posterior_init = self.z2_prior_init  # shared, as in the reference
        self.z2_posterior = self.z2_prior
        self.reward = GaussianHead(2 * (z1_dim + z2_dim) + action_dim, 1, hu)
        self.encoder = SlacEncoder(feature_dim, image_size, channels)
        self.decoder = SlacDecoder(z1_dim + z2_dim, channels, math.sqrt(0.1), image_size)
        _init_xavier_(self, init_generator(gen, seed))

    def forward(self, state_, action_, reward_, done_, noise: Noise = None):
        return self.compute_loss(state_, action_, reward_, done_, noise)

    # -- sampling -----------------------------------------------------------
    def posterior_noise(self, batch: int, steps: int, generator: Optional[torch.Generator],
                        like: torch.Tensor) -> List[torch.Tensor]:
        """The 2·steps standard normals of one posterior sample, in the
        order ``sample_posterior`` uses them."""
        out = []
        for _ in range(steps):
            for dim in (self.z1_dim, self.z2_dim):
                out.append(torch.randn(batch, dim, generator=generator, device=like.device,
                                       dtype=like.dtype))
        return out

    def sample_posterior(self, features_: torch.Tensor, actions_: torch.Tensor,
                         noise: Noise = None):
        """features [B, S+1, F], actions [B, S, A] → (z1 means, z1 stds,
        z1s, z2s), each [B, S+1, ·]."""
        B, S = actions_.shape[:2]
        if noise is None or isinstance(noise, torch.Generator):
            noise = self.posterior_noise(B, S + 1, noise, features_)
        eps = iter(noise)
        z1_mean, z1_std = self.z1_posterior_init(features_[:, 0])
        z1 = z1_mean + next(eps) * z1_std
        z2_mean, z2_std = self.z2_prior_init(z1)
        z2 = z2_mean + next(eps) * z2_std
        z1_means, z1_stds, z1s, z2s = [z1_mean], [z1_std], [z1], [z2]
        for t in range(1, S + 1):
            z1_mean, z1_std = self.z1_posterior(
                torch.cat([features_[:, t], z2, actions_[:, t - 1]], dim=1))
            z1 = z1_mean + next(eps) * z1_std
            z2_mean, z2_std = self.z2_prior(torch.cat([z1, z2, actions_[:, t - 1]], dim=1))
            z2 = z2_mean + next(eps) * z2_std
            z1_means.append(z1_mean)
            z1_stds.append(z1_std)
            z1s.append(z1)
            z2s.append(z2)
        stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
        return stack(z1_means), stack(z1_stds), stack(z1s), stack(z2s)

    def sample_prior(self, actions_: torch.Tensor, z2_post_: torch.Tensor):
        """Prior z1 means and stds given the posterior z2 trace."""
        S = actions_.shape[1]
        m0, s0 = self.z1_prior_init(actions_)
        m_, s_ = self.z1_prior(torch.cat([z2_post_[:, :S], actions_], dim=-1))
        return torch.cat([m0[:, None], m_], dim=1), torch.cat([s0[:, None], s_], dim=1)

    # -- ELBO ---------------------------------------------------------------
    def compute_loss(self, state_, action_, reward_, done_, noise: Noise = None):
        """state [B, S+1, H, W, C] in [0, 1]; action [B, S, A]; reward and
        done [B, S, 1] → (loss_kld, loss_image, loss_reward)."""
        feature_ = self.encoder(state_)
        z1_mean_post, z1_std_post, z1_, z2_ = self.sample_posterior(feature_, action_, noise)
        z1_mean_pri, z1_std_pri = self.sample_prior(action_, z2_)

        kld = calculate_kl_divergence(z1_mean_post, z1_std_post, z1_mean_pri, z1_std_pri)
        loss_kld = kld.mean(dim=0).sum()

        z_ = torch.cat([z1_, z2_], dim=-1)
        state_mean, state_std = self.decoder(z_)
        loss_image = gaussian_nll(state_, state_mean, state_std).mean(dim=0).sum()

        x = torch.cat([z_[:, :-1], action_, z_[:, 1:]], dim=-1)
        r_mean, r_std = self.reward(x)
        loss_reward = (gaussian_nll(reward_, r_mean, r_std) * (1.0 - done_)).mean(dim=0).sum()
        return loss_kld, loss_image, loss_reward

    # -- inference helpers ----------------------------------------------------
    def encode(self, state_: torch.Tensor) -> torch.Tensor:
        return self.encoder(state_)

    def latent_z(self, features_: torch.Tensor, actions_: torch.Tensor,
                 noise: Noise = None) -> torch.Tensor:
        """The posterior sample's z trace [B, S+1, z1 + z2]."""
        _, _, z1_, z2_ = self.sample_posterior(features_, actions_, noise)
        return torch.cat([z1_, z2_], dim=-1)
