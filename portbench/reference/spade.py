"""GauGAN's generator (``netG=spade``) written from its layer equations in plain PyTorch.

Sources: Park et al., "Semantic Image Synthesis with Spatially-Adaptive
Normalization", CVPR 2019 (arXiv:1903.07291), and NVlabs/SPADE:
``models/networks/generator.py::SPADEGenerator``,
``architecture.py::SPADEResnetBlock``, ``normalization.py::SPADE``,
``data/ade20k_dataset.py``. Options are SPADE's (``opt``, a configuration's
``"opt"`` group).

- Input: label ids → one-hot ``[B, semantic_nc, H, W]`` (``onehot``, as
  ``preprocess_input`` scatters them); semantic_nc = label_nc + dontcare.
- ``x = fc(nearest(seg, sh×sw))``, a 3×3 conv to 16·ngf; then the res blocks
  head_0 (16·ngf), ×2, G_middle_0, G_middle_1, then ×2 and up_0..up_3
  (8, 4, 2, 1 ·ngf); ``tanh(conv_img(lrelu(x, 0.2)))``.
- Block: ``out = shortcut + conv_1(lrelu(norm_1(conv_0(lrelu(norm_0(x))))))``,
  shortcut ``conv_s(norm_s(x))`` (1×1, no bias) where fin ≠ fout, else x;
  fmid = min(fin, fout); conv_0, conv_1 and conv_s spectral-normed with
  ``norm_G`` ``spectral…``.
- SPADE norm: ``param_free(x)·(1 + γ) + β`` with ``γ, β = conv3x3(relu(
  conv3x3(nearest(seg, x's size), nhidden)))``; the param-free norm is a
  batch norm without affine (``syncbatch``/``batch``) or instance norm.

Weights are a dict in SPADE's own names: a spectral-normed conv as
``weight_orig``, ``weight_u``, ``weight_v`` (and ``bias``), the norm's first
conv as ``mlp_shared.0``, a batch norm's ``param_free_norm.running_mean`` and
``running_var``. Every convolution goes through ``prec``
(``precision.Precision``), so one forward serves the float32 reference and
its lower-precision control.

Departures from SPADE's code, each for a reason:
- Inference only (``test.py`` puts the model in ``eval()``): the batch norm
  reads its running statistics, and spectral norm divides by ``uᵀWv`` from
  the stored vectors without a power iteration, as an eval-mode
  ``torch.nn.utils.spectral_norm`` does. ``batch_statistics`` computes
  running statistics for seeded weights with batch statistics (one GPU's
  batch, where SPADE's synchronized batch norm pools over its GPUs).
- ``param_free="none"`` leaves the param-free norm out (a control).
- No VAE encoder, no instance edge map and SPADE's ``normal`` upsampling
  only (``use_vae`` false, ``no_instance`` true, ``num_upsampling_layers``
  ``normal``); frames come out NHWC, not NCHW.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
UPSAMPLING_LAYERS = 5  # num_upsampling_layers "normal"
EPS = 1e-5  # BatchNorm2d's and InstanceNorm2d's default


def semantic_nc(opt) -> int:
    if opt["use_vae"] or not opt["no_instance"] or opt["num_upsampling_layers"] != "normal":
        raise ValueError("the reference takes use_vae false, no_instance true and "
                         "num_upsampling_layers normal")
    return opt["label_nc"] + int(opt["contain_dontcare_label"])


def param_free_kind(opt) -> str:
    kind = opt["norm_G"].replace("spectral", "").replace("spade", "", 1)
    if kind not in ("syncbatch3x3", "batch3x3", "instance3x3"):
        raise ValueError(f"norm_G {opt['norm_G']!r}")
    return "instance" if kind.startswith("instance") else "batch"


def latent_hw(opt) -> Tuple[int, int]:
    """SPADE's (sh, sw): the crop over 2^(upsampling layers)."""
    semantic_nc(opt)  # the options the reference takes
    sw = opt["crop_size"] // 2 ** UPSAMPLING_LAYERS
    return round(sw / opt["aspect_ratio"]), sw


def schedule(opt) -> List[Tuple[str, int, int, bool]]:
    """(block, fin, fout, ×2 upsample before it), in SPADE's order."""
    semantic_nc(opt)
    nf = opt["ngf"]
    out = [("head_0", 16 * nf, 16 * nf, False), ("G_middle_0", 16 * nf, 16 * nf, True),
           ("G_middle_1", 16 * nf, 16 * nf, False)]
    return out + [(f"up_{k}", c, c // 2, True)
                  for k, c in enumerate((16 * nf, 8 * nf, 4 * nf, 2 * nf))]


def block_norms(fin: int, fout: int) -> List[Tuple[str, int]]:
    """(norm, width) of one block: norm_0 on x, norm_1 on fmid, norm_s on x
    where the width changes."""
    return [("norm_0", fin), ("norm_1", min(fin, fout))] + (
        [("norm_s", fin)] if fin != fout else [])


def block_sizes(opt) -> List[Tuple[int, int]]:
    """Each block's (H, W), in ``schedule`` order."""
    (h, w), out = latent_hw(opt), []
    for *_, up in schedule(opt):
        if up:
            h, w = 2 * h, 2 * w
        out.append((h, w))
    return out


def conv_spec(opt) -> Dict[str, tuple]:
    """Every convolution's ``weight`` (``weight_orig`` where spectral-normed)
    and ``bias``, by name: the leaves a seed draws."""
    snc, nh = semantic_nc(opt), opt["nhidden"]
    spectral = opt["norm_G"].startswith("spectral")
    spec: Dict[str, tuple] = {}

    def conv(name, c_out, c_in, k=3, bias=True, sn=False):
        spec[f"{name}.weight_orig" if sn else f"{name}.weight"] = (c_out, c_in, k, k)
        if bias:
            spec[f"{name}.bias"] = (c_out,)

    conv("fc", 16 * opt["ngf"], snc)
    for name, fin, fout, _ in schedule(opt):
        for norm, width in block_norms(fin, fout):
            conv(f"{name}.{norm}.mlp_shared.0", nh, snc)
            conv(f"{name}.{norm}.mlp_gamma", width, nh)
            conv(f"{name}.{norm}.mlp_beta", width, nh)
        fmid = min(fin, fout)
        conv(f"{name}.conv_0", fmid, fin, sn=spectral)
        conv(f"{name}.conv_1", fout, fmid, sn=spectral)
        if fin != fout:
            conv(f"{name}.conv_s", fout, fin, k=1, bias=False, sn=spectral)
    conv("conv_img", 3, schedule(opt)[-1][2])
    return spec


def stat_names(opt) -> Dict[str, int]:
    """Each batch norm's name → its width (empty for instance norm)."""
    if param_free_kind(opt) != "batch":
        return {}
    return {f"{name}.{norm}": width for name, fin, fout, _ in schedule(opt)
            for norm, width in block_norms(fin, fout)}


def power_iteration(w: torch.Tensor, u: torch.Tensor, steps: int):
    """``torch.nn.utils.spectral_norm``'s power iteration on W = w flattened
    to [out, rest] from a start ``u``: (u, v) after ``steps`` rounds."""
    m = w.flatten(1)
    for _ in range(steps):
        v = F.normalize(torch.mv(m.t(), u), dim=0, eps=1e-12)
        u = F.normalize(torch.mv(m, v), dim=0, eps=1e-12)
    return u, v


def conv_weight(W: Weights, name: str) -> torch.Tensor:
    """A conv's weight: ``weight_orig / (uᵀ W v)`` where spectral-normed."""
    if f"{name}.weight_orig" not in W:
        return W[f"{name}.weight"]
    w = W[f"{name}.weight_orig"]
    sigma = torch.dot(W[f"{name}.weight_u"], torch.mv(w.flatten(1), W[f"{name}.weight_v"]))
    return w / sigma


def onehot(ids: torch.Tensor, channels: int, dtype=torch.float32) -> torch.Tensor:
    """Label ids [B, H, W] → one-hot [B, channels, H, W] (``preprocess_input``)."""
    out = torch.zeros(ids.shape[0], channels, *ids.shape[1:], dtype=dtype, device=ids.device)
    return out.scatter_(1, ids.long().unsqueeze(1), 1.0)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """``InstanceNorm2d(affine=False)`` written out (two-pass variance over H
    and W), which also takes a 1×1 map (0 there) where the module raises."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS)


def _batch_norm(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, W[f"{name}.param_free_norm.running_mean"].to(x.dtype),
                        W[f"{name}.param_free_norm.running_var"].to(x.dtype), training=False,
                        eps=EPS)


def generator(W: Weights, opt, seg: torch.Tensor, prec, param_free: Optional[str] = None,
              norm: Optional[Callable] = None) -> torch.Tensor:
    """seg [B, semantic_nc, H, W] (one-hot) → frames [B, H, W, 3] in [-1, 1].
    ``param_free``: the configuration's kind by default, or "none"; ``norm``
    (name, x) → normalised x, if given, replaces the param-free norm."""
    kind = param_free or param_free_kind(opt)
    if norm is None:
        norm = {"batch": lambda n, x: _batch_norm(W, n, x),
                "instance": lambda n, x: instance_norm(x),
                "none": lambda n, x: x}[kind]
    lrelu = lambda t: F.leaky_relu(t, 0.2)

    def conv(name, x, padding=1):
        return prec.conv(x, conv_weight(W, name), W.get(f"{name}.bias"), padding=padding)

    def spade(name, x):
        s = F.interpolate(seg, size=x.shape[2:], mode="nearest")
        h = F.relu(conv(f"{name}.mlp_shared.0", s))
        return norm(name, x) * (1 + conv(f"{name}.mlp_gamma", h)) + conv(f"{name}.mlp_beta", h)

    x = conv("fc", F.interpolate(seg, size=latent_hw(opt), mode="nearest"))
    for name, fin, fout, up in schedule(opt):
        if up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        dx = conv(f"{name}.conv_0", lrelu(spade(f"{name}.norm_0", x)))
        dx = conv(f"{name}.conv_1", lrelu(spade(f"{name}.norm_1", dx)))
        xs = conv(f"{name}.conv_s", spade(f"{name}.norm_s", x), padding=0) if fin != fout else x
        x = xs + dx
    return torch.tanh(conv("conv_img", lrelu(x))).permute(0, 2, 3, 1)


@torch.no_grad()
def batch_statistics(W: Weights, opt, batches: List[torch.Tensor], prec) -> Weights:
    """Running statistics as a train-mode pass with ``momentum=None`` leaves
    them: each batch normalised by its own mean and (biased) variance, the
    running mean and unbiased variance averaged over the batches. ``batches``
    are one-hot maps."""
    sums: Dict[str, List[torch.Tensor]] = {}

    def norm(name, x):
        n = x.numel() // x.shape[1]
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
        acc = sums.setdefault(name, [torch.zeros_like(mean), torch.zeros_like(var)])
        acc[0] += mean
        acc[1] += var * n / (n - 1)
        return F.batch_norm(x, mean, var, training=False, eps=EPS)

    for seg in batches:
        generator(W, opt, seg, prec, norm=norm)
    out = {}
    for name, (m, v) in sums.items():
        out[f"{name}.param_free_norm.running_mean"] = m / len(batches)
        out[f"{name}.param_free_norm.running_var"] = v / len(batches)
    return out
