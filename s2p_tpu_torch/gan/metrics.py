"""Image-fidelity metrics of the train CLI: PSNR, SSIM and FID over VGG
features.

The port of the part of ``s2p_tpu/gan/metrics.py`` that ``train_gan``
uses. PSNR and SSIM batch over leading dims of NHWC images in [-1, 1] and
run on the images' device; the Fréchet distance is computed on the host
with scipy's ``sqrtm``, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from s2p_tpu_torch.gan.perceptual import VGG19Features


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio per image pair, data range [-1, 1] → 2."""
    mse = ((a - b) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(4.0 / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise valid-mode 2-D filter over NCHW."""
    c = x.shape[1]
    return F.conv2d(x, kernel.to(x)[None, None].expand(c, 1, -1, -1), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Structural similarity (11×11 Gaussian σ = 1.5, K1 = 0.01, K2 = 0.03,
    L = 2), averaged over space and channels; range [-1, 1]."""
    L = 2.0
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    kern = _gaussian_kernel()
    lead = a.shape[:-3]
    a = a.reshape((-1,) + a.shape[-3:]).float().permute(0, 3, 1, 2)
    b = b.reshape((-1,) + b.shape[-3:]).float().permute(0, 3, 1, 2)
    mu_a, mu_b = _filter2d(a, kern), _filter2d(b, kern)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2d(a * a, kern) - mu_aa
    s_bb = _filter2d(b * b, kern) - mu_bb
    s_ab = _filter2d(a * b, kern) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return (num / den).mean(dim=(1, 2, 3)).reshape(lead)


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    feats = np.asarray(feats, np.float64)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    """d² = |μ1−μ2|² + Tr(Σ1 + Σ2 − 2(Σ1Σ2)^{1/2}) (Heusel et al. 2017)."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean, _ = linalg.sqrtm(sigma1 @ sigma2, disp=False)
    if not np.isfinite(covmean).all():
        # the usual small-sample stabilisation: jitter the diagonals
        eps = 1e-6 * np.eye(sigma1.shape[0])
        covmean, _ = linalg.sqrtm((sigma1 + eps) @ (sigma2 + eps), disp=False)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def vgg_fid_extractor(state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                      device: str | torch.device = "cuda"
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Feature extractor for FID: relu4_1 of ``VGG19Features`` (the given
    weights, or the seeded random network), mean-pooled over space."""
    vgg = VGG19Features(seed=seed, device=device)
    if state_dict is not None:
        vgg.load_state_dict(state_dict, strict=True)

    @torch.no_grad()
    def extract(images: torch.Tensor) -> torch.Tensor:
        images = torch.as_tensor(images, device=vgg.mean.device).float()
        return vgg(images)[3].mean(dim=(1, 2))

    return extract


def compute_fid(extractor: Callable[[torch.Tensor], torch.Tensor],
                real_batches: Iterable, fake_batches: Iterable) -> float:
    """Stream batches (NHWC in [-1, 1]) through the extractor; the Fréchet
    distance between the two feature distributions."""

    def collect(batches) -> np.ndarray:
        out: List[np.ndarray] = [extractor(b).double().cpu().numpy() for b in batches]
        return np.concatenate(out, axis=0)

    mu_r, s_r = feature_stats(collect(real_batches))
    mu_f, s_f = feature_stats(collect(fake_batches))
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def evaluate_pairs(fake, real) -> dict:
    """PSNR and SSIM over aligned generated and ground-truth frames (numpy
    arrays or tensors, on their device)."""
    f = torch.as_tensor(fake).float()
    r = torch.as_tensor(real, device=f.device).float()
    return {"psnr": psnr(f, r).mean().item(), "ssim": ssim(f, r).mean().item()}
