"""The S2P networks written from the architecture in plain PyTorch.

Weights are dicts of tensors keyed by parameter name; images are NHWC in
[-1, 1] at the interface and NCHW inside. Every convolution and linear
layer goes through ``prec`` (``precision.Precision``), so one forward
serves the float32 reference and its lower-precision controls.

- Generator (``netG=s2p``): a NeRF embedding of the state through two
  linear layers (leaky ReLU 0.2) to ``state_embed_dim``; a stride-2 conv
  pyramid over the previous image (full resolution first); a seed map
  from the embedding at the coarsest size; one residual block per size,
  each of MAT norms (instance norm ·(1 + γ) + β, with γ and β convolved
  from the constant state map beside the image feature of that size),
  3×3 convs and, where the width changes, a normed 1×1 shortcut; nearest
  upsampling between sizes; a 3×3 output conv and tanh.
- Discriminator: per scale a PatchGAN of 4×4 convs (pad 2, leaky ReLU
  0.2, affine-free instance norm after the first), over (previous image,
  state map, image); each further scale sees a 3×3 stride-2 average pool
  (edge windows count their valid pixels only).
- VGG19 features at relu1_1 … relu5_1 of ImageNet-normalised inputs.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

# VGG19's convs by torchvision index, their widths, and those a 2×2 max pool precedes
VGG19_CHANNELS = {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256, 16: 256,
                  19: 512, 21: 512, 23: 512, 25: 512, 28: 512}
VGG19_POOL_BEFORE = (5, 10, 19, 28)
VGG19_SLICE_ENDS = (0, 5, 10, 19, 28)  # relu1_1, relu2_1, relu3_1, relu4_1, relu5_1
VGG19_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def sizes(cfg) -> List[int]:
    """Decoder sizes, coarsest first: repeated ceil(n / 2) from the image size."""
    out = [cfg["image_size"]]
    for _ in range(cfg["n_up"]):
        out.append(-(-out[-1] // 2))
    return out[::-1]


def block_channels(cfg):
    ngf, n = cfg["ngf"], cfg["n_up"] + 1
    ins = [8 * ngf, 8 * ngf, 4 * ngf, 2 * ngf, ngf][:n]
    outs = [8 * ngf, 4 * ngf, 2 * ngf, ngf, ngf][:n]
    return list(zip(ins, outs))


def encoder_channels(cfg) -> List[int]:
    ngf = cfg["ngf"]
    return [ngf, 2 * ngf, 4 * ngf, 8 * ngf, 8 * ngf][: cfg["n_up"] + 1]


def block_norms(c_in: int, c_out: int):
    """(norm name, width) of one residual block."""
    norms = [("norm_0", c_in), ("norm_1", min(c_in, c_out))]
    return norms + ([("norm_s", c_in)] if c_in != c_out else [])


def generator_spec(cfg) -> Dict[str, tuple]:
    S, E, Fq = cfg["state_dim"], cfg["state_embed_dim"], cfg["state_freqs"]
    hid, out_ch = cfg["mat_hidden"], cfg["out_channels"]
    spec: Dict[str, tuple] = {}

    def conv(name, c_out, c_in, k=3, bias=True):
        spec[f"{name}.weight"] = (c_out, c_in, k, k)
        if bias:
            spec[f"{name}.bias"] = (c_out,)

    def linear(name, c_out, c_in):
        spec[f"{name}.weight"] = (c_out, c_in)
        spec[f"{name}.bias"] = (c_out,)

    enc, c_prev = encoder_channels(cfg), out_ch
    for i, c in enumerate(enc):
        conv(f"img_enc.enc{i}", c, c_prev)
        c_prev = c
    linear("state_fc0", E, S * (2 * Fq + 1))
    linear("state_fc1", E, E)
    blocks = block_channels(cfg)
    linear("seed_fc", sizes(cfg)[0] ** 2 * blocks[0][0], E)
    for i, (c_in, c_out) in enumerate(blocks):
        for norm, width in block_norms(c_in, c_out):
            conv(f"block_{i}.{norm}.mlp_shared", hid, E + enc[::-1][i])
            conv(f"block_{i}.{norm}.mlp_gamma", width, hid)
            conv(f"block_{i}.{norm}.mlp_beta", width, hid)
        fmid = min(c_in, c_out)
        conv(f"block_{i}.conv_0", fmid, c_in)
        conv(f"block_{i}.conv_1", c_out, fmid)
        if c_in != c_out:
            conv(f"block_{i}.conv_s", c_out, c_in, k=1, bias=False)
    conv("conv_img", out_ch, blocks[-1][1])
    return spec


def discriminator_spec(cfg) -> Dict[str, tuple]:
    d = cfg["discriminator"]
    in_ch = 2 * cfg["out_channels"] + cfg["state_dim"]
    spec: Dict[str, tuple] = {}
    for s in range(d["num_scales"]):
        c = d["ndf"]
        spec[f"scale{s}.conv0.weight"] = (c, in_ch, 4, 4)
        spec[f"scale{s}.conv0.bias"] = (c,)
        for i in range(1, d["n_layers"]):
            c_prev, c = c, min(2 * c, 512)
            spec[f"scale{s}.conv{i}.weight"] = (c, c_prev, 4, 4)
        spec[f"scale{s}.conv_out.weight"] = (1, c, 4, 4)
        spec[f"scale{s}.conv_out.bias"] = (1,)
    return spec


def vgg19_spec() -> Dict[str, tuple]:
    spec, c_prev = {}, 3
    for li, c in VGG19_CHANNELS.items():
        spec[f"conv{li}.weight"] = (c, c_prev, 3, 3)
        spec[f"conv{li}.bias"] = (c,)
        c_prev = c
    return spec


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Over H and W of NCHW ``x``: two-pass population variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def positional_embedding(state: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[state, then per state dimension sin(x·2^k) for k < F and cos(x·2^k)]."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=state.dtype, device=state.device)
    xf = state[..., None] * freqs
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1).flatten(-2)
    return torch.cat([state, enc], dim=-1)


def _mat_norm(W, name, x, state_map, feat, prec):
    cond = torch.cat([state_map, feat], dim=1)
    h = F.relu(prec.conv(cond, W[f"{name}.mlp_shared.weight"], W[f"{name}.mlp_shared.bias"],
                         padding=1))
    gamma = prec.conv(h, W[f"{name}.mlp_gamma.weight"], W[f"{name}.mlp_gamma.bias"], padding=1)
    beta = prec.conv(h, W[f"{name}.mlp_beta.weight"], W[f"{name}.mlp_beta.bias"], padding=1)
    return instance_norm(x) * (1 + gamma) + beta


def generator(W: Weights, cfg, state: torch.Tensor, prev: torch.Tensor, prec) -> torch.Tensor:
    """One step i_{t+1} = G(s_{t+1}, i_t): state [B, S], prev [B, H, W, C] → [B, H, W, C]."""
    lrelu = lambda t: F.leaky_relu(t, 0.2)
    h = prev.permute(0, 3, 1, 2)
    feats = {}
    for i in range(cfg["n_up"] + 1):
        h = lrelu(prec.conv(h, W[f"img_enc.enc{i}.weight"], W[f"img_enc.enc{i}.bias"],
                            stride=1 if i == 0 else 2, padding=1))
        feats[h.shape[-1]] = h
    e = lrelu(prec.linear(positional_embedding(state, cfg["state_freqs"]),
                          W["state_fc0.weight"], W["state_fc0.bias"]))
    e = lrelu(prec.linear(e, W["state_fc1.weight"], W["state_fc1.bias"]))
    chain, blocks = sizes(cfg), block_channels(cfg)
    x = prec.linear(e, W["seed_fc.weight"], W["seed_fc.bias"])
    x = x.reshape(-1, chain[0], chain[0], blocks[0][0]).permute(0, 3, 1, 2)
    for i, (size, (c_in, c_out)) in enumerate(zip(chain, blocks)):
        b = f"block_{i}"
        smap = e[:, :, None, None].expand(-1, -1, size, size)
        norm = lambda t, n: _mat_norm(W, f"{b}.{n}", t, smap, feats[size], prec)
        y = prec.conv(lrelu(norm(x, "norm_0")), W[f"{b}.conv_0.weight"], W[f"{b}.conv_0.bias"],
                      padding=1)
        y = prec.conv(lrelu(norm(y, "norm_1")), W[f"{b}.conv_1.weight"], W[f"{b}.conv_1.bias"],
                      padding=1)
        s = prec.conv(norm(x, "norm_s"), W[f"{b}.conv_s.weight"]) if c_in != c_out else x
        x = s + y
        if i < len(chain) - 1:
            x = F.interpolate(x, size=(chain[i + 1],) * 2, mode="nearest")
    x = prec.conv(lrelu(x), W["conv_img.weight"], W["conv_img.bias"], padding=1)
    return torch.tanh(x).permute(0, 2, 3, 1)


def discriminator(W: Weights, cfg, state, prev, image, prec) -> List[List[torch.Tensor]]:
    """Per scale, the NHWC feature maps of each layer, the patch logits last."""
    d = cfg["discriminator"]
    b, h, w, _ = image.shape
    smap = state[:, None, None, :].expand(b, h, w, state.shape[-1])
    x = torch.cat([prev, smap, image], dim=-1).permute(0, 3, 1, 2)
    lrelu = lambda t: F.leaky_relu(t, 0.2)
    outs = []
    for s in range(d["num_scales"]):
        p = f"scale{s}"
        y = lrelu(prec.conv(x, W[f"{p}.conv0.weight"], W[f"{p}.conv0.bias"], stride=2, padding=2))
        feats = [y]
        for i in range(1, d["n_layers"]):
            stride = 2 if i < d["n_layers"] - 1 else 1
            y = lrelu(instance_norm(prec.conv(y, W[f"{p}.conv{i}.weight"], stride=stride,
                                              padding=2)))
            feats.append(y)
        feats.append(prec.conv(y, W[f"{p}.conv_out.weight"], W[f"{p}.conv_out.bias"], padding=2))
        outs.append([f.permute(0, 2, 3, 1) for f in feats])
        if s < d["num_scales"] - 1:
            x = F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)
    return outs


def vgg19_features(W: Weights, x: torch.Tensor, prec) -> List[torch.Tensor]:
    """relu1_1 … relu5_1 (NCHW) of NHWC images in [-1, 1]."""
    mean = x.new_tensor(IMAGENET_MEAN)
    std = x.new_tensor(IMAGENET_STD)
    h = (((x + 1.0) * 0.5 - mean) / std).permute(0, 3, 1, 2)
    feats = []
    for li in VGG19_CHANNELS:
        if li in VGG19_POOL_BEFORE:
            h = F.max_pool2d(h, 2, 2)
        h = F.relu(prec.conv(h, W[f"conv{li}.weight"], W[f"conv{li}.bias"], padding=1))
        if li in VGG19_SLICE_ENDS:
            feats.append(h)
    return feats


def vgg19_loss(W: Weights, x, y, prec) -> torch.Tensor:
    fx, fy = vgg19_features(W, x, prec), vgg19_features(W, y.detach(), prec)
    return sum(w * (a - b.detach()).abs().mean() for w, a, b in zip(VGG19_SLICE_WEIGHTS, fx, fy))
