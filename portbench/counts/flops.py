"""Model FLOPs of the S2P networks, counted from the configuration's shapes.

Two FLOPs a multiply-accumulate of every convolution (all taps, padding
included) and linear layer, as the module path defines the model, whatever
path computes it. ``tests/test_portbench_counts.py`` holds these counts to
``torch.utils.flop_counter.FlopCounterMode`` over the reference.
"""

from __future__ import annotations

from portbench.reference import nets


def conv(batch: int, c_in: int, c_out: int, k: int, out_size: int) -> int:
    return 2 * batch * c_out * out_size * out_size * c_in * k * k


def linear(batch: int, n_in: int, n_out: int) -> int:
    return 2 * batch * n_in * n_out


def generator_forward(cfg, batch: int) -> int:
    S, E, Fq = cfg["state_dim"], cfg["state_embed_dim"], cfg["state_freqs"]
    hid, out_ch = cfg["mat_hidden"], cfg["out_channels"]
    chain, blocks, enc = nets.sizes(cfg), nets.block_channels(cfg), nets.encoder_channels(cfg)
    total, c_prev = 0, out_ch
    for c, size in zip(enc, chain[::-1]):  # the pyramid, full resolution first
        total += conv(batch, c_prev, c, 3, size)
        c_prev = c
    total += linear(batch, S * (2 * Fq + 1), E) + linear(batch, E, E)
    total += linear(batch, E, chain[0] ** 2 * blocks[0][0])
    for size, (c_in, c_out), c_img in zip(chain, blocks, enc[::-1]):
        for _, width in nets.block_norms(c_in, c_out):
            total += conv(batch, E + c_img, hid, 3, size) + 2 * conv(batch, hid, width, 3, size)
        fmid = min(c_in, c_out)
        total += conv(batch, c_in, fmid, 3, size) + conv(batch, fmid, c_out, 3, size)
        if c_in != c_out:
            total += conv(batch, c_in, c_out, 1, size)
    return total + conv(batch, blocks[-1][1], out_ch, 3, chain[-1])


def discriminator_forward(cfg, batch: int) -> int:
    """All scales over one set of images."""
    d = cfg["discriminator"]
    size, total = cfg["image_size"], 0
    for s in range(d["num_scales"]):
        c_prev, c, n = 2 * cfg["out_channels"] + cfg["state_dim"], d["ndf"], size
        n = n // 2 + 1  # k4 s2 p2
        total += conv(batch, c_prev, c, 4, n)
        for i in range(1, d["n_layers"]):
            c_prev, c = c, min(2 * c, 512)
            n = n // 2 + 1 if i < d["n_layers"] - 1 else n + 1
            total += conv(batch, c_prev, c, 4, n)
        total += conv(batch, c, 1, 4, n + 1)
        size = -(-size // 2)  # 3×3 stride-2 pool, pad 1
    return total


def vgg19_forward(image_size: int, batch: int) -> int:
    total, c_prev, n = 0, 3, image_size
    for li, c in nets.VGG19_CHANNELS.items():
        if li in nets.VGG19_POOL_BEFORE:
            n //= 2
        total += conv(batch, c_prev, c, 3, n)
        c_prev = c
    return total


def train_step(cfg, batch: int) -> int:
    """One D update and one G update, a backward counted as twice its
    forward where weights and inputs both get gradients and once where only
    inputs do (G's pass through D, VGG19):

    - D update: G forward; D forward on real and fake; D backward on both.
    - R1 (every ``r1_interval``-th D update, shared out): D's backward to the
      real image with its graph, and that backward's own backward: 3 D
      forwards on the real images.
    - G update: G forward and backward; D forward and backward to the
      input on the fake, forward on the real; VGG19 forward and backward to
      the input on the fake, forward on the real.
    """
    g = generator_forward(cfg, batch)
    d = discriminator_forward(cfg, batch)
    v = vgg19_forward(cfg["image_size"], batch)
    r1 = 3 * d / cfg["training"]["r1_interval"]
    return g + 6 * d + r1 + 3 * g + 3 * d + 3 * v
