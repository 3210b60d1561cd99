"""Generic CNN / deconv building blocks.

The port of ``s2p_tpu/nn/cnn.py``: conv stacks (kernel, stride, padding per
layer) with optional norm and 2×2 max pooling, flattened into an MLP head
(``CNN``), and the transposed mirror, an MLP stem into a deconv stack
(``DCNN``). Images are NHWC at the API, as in the JAX package; inside, the
convs run NCHW, and the flatten follows the NHWC order (H, W, C) so the
head's weights are flax's.

``ConvTranspose2dTorch`` is ``nn.ConvTranspose2d`` itself, whose
``H_out = (H−1)·stride − 2·padding + kernel + output_padding`` the JAX
module reproduces with a dilated conv over a flipped kernel. flax stores
that kernel ``(k, k, in, out)`` un-flipped; torch's weight is ``(in, out,
k, k)``: ``kernel.transpose(2, 3, 0, 1)``.

Layer names are flax's (``conv{i}``, ``norm{i}``, ``head``, ``stem``,
``deconv{i}``); kernels take flax's default init (LeCun normal), biases
zero.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.nn.initializers import lecun_normal_
from s2p_tpu_torch.nn.mlp import LAYER_NORM_EPS, Mlp, init_generator


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    """PyTorch's transposed conv, NCHW; flax's LeCun-normal kernel init
    (fan-in = in · k · k) from ``gen``, zero bias."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, output_padding: int = 0, use_bias: bool = True,
                 gen: Optional[torch.Generator] = None):
        super().__init__(in_channels, features, kernel_size, stride=stride, padding=padding,
                         output_padding=output_padding, bias=use_bias)
        lecun_normal_(self.weight, init_generator(gen, 0), fan=in_channels * kernel_size ** 2)
        if use_bias:
            nn.init.zeros_(self.bias)


def _conv(c_in: int, c_out: int, k: int, s: int, p: int, gen: torch.Generator) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, k, stride=s, padding=p)
    lecun_normal_(conv.weight, gen)
    nn.init.zeros_(conv.bias)
    return conv


class _ChannelLayerNorm(nn.LayerNorm):
    """flax's ``LayerNorm`` on NHWC: over the channels of each pixel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


class CNN(nn.Module):
    """Conv stack (+ MLP head) over NHWC images ``[..., H, W, C]``."""

    def __init__(self, input_shape: Tuple[int, int, int], channels: Sequence[int],
                 kernel_sizes: Sequence[int], strides: Sequence[int],
                 paddings: Sequence[int], hidden_sizes: Sequence[int] = (),
                 output_size: Optional[int] = None, hidden_activation: Callable = F.relu,
                 output_activation: Optional[Callable] = None, norm: Optional[str] = None,
                 pool_every: int = 0, init_w: float = 3e-3,
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        gen = init_generator(gen, seed)
        h, w, c_prev = input_shape
        self.hidden_activation, self.norm, self.pool_every = hidden_activation, norm, pool_every
        self.n_convs = len(channels)
        for i, (c, k, s, p) in enumerate(zip(channels, kernel_sizes, strides, paddings,
                                              strict=True)):
            self.add_module(f"conv{i}", _conv(c_prev, c, k, s, p, gen))
            if norm == "layer":
                self.add_module(f"norm{i}", _ChannelLayerNorm(c, eps=LAYER_NORM_EPS))
            elif norm == "group":
                self.add_module(f"norm{i}", nn.GroupNorm(min(32, c), c, eps=LAYER_NORM_EPS))
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            if pool_every and (i + 1) % pool_every == 0:
                h, w = h // 2, w // 2
            c_prev = c
        self.flat_size = h * w * c_prev
        self.head = None
        if output_size is not None:
            self.head = Mlp(self.flat_size, hidden_sizes, output_size, init_w=init_w,
                            hidden_activation=hidden_activation,
                            output_activation=output_activation, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        h = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            h = getattr(self, f"conv{i}")(h)
            if self.norm is not None:
                h = getattr(self, f"norm{i}")(h)
            h = self.hidden_activation(h)
            if self.pool_every and (i + 1) % self.pool_every == 0:
                h = F.max_pool2d(h, 2, 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flax's (H, W, C) order
        if self.head is not None:
            h = self.head(h)
        return h.reshape(tuple(lead) + tuple(h.shape[1:]))


class DCNN(nn.Module):
    """MLP stem + transposed-conv stack: ``[..., D]`` → NHWC images."""

    def __init__(self, input_size: int, fc_hidden_sizes: Sequence[int],
                 deconv_input_shape: Tuple[int, int, int], channels: Sequence[int],
                 kernel_sizes: Sequence[int], strides: Sequence[int],
                 paddings: Sequence[int], hidden_activation: Callable = F.relu,
                 output_activation: Optional[Callable] = None,
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        gen = init_generator(gen, seed)
        self.hidden_activation, self.output_activation = hidden_activation, output_activation
        self.deconv_input_shape = tuple(deconv_input_shape)
        H, W, C = deconv_input_shape
        self.stem = Mlp(input_size, fc_hidden_sizes, H * W * C,
                        hidden_activation=hidden_activation, gen=gen)
        self.n_deconvs = len(channels)
        c_prev = C
        for i, (c, k, s, p) in enumerate(zip(channels, kernel_sizes, strides, paddings,
                                              strict=True)):
            self.add_module(f"deconv{i}", ConvTranspose2dTorch(c_prev, c, k, s, p, gen=gen))
            c_prev = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        H, W, C = self.deconv_input_shape
        h = self.hidden_activation(self.stem(x.reshape(-1, x.shape[-1])))
        h = h.reshape(-1, H, W, C).permute(0, 3, 1, 2)
        for i in range(self.n_deconvs):
            h = getattr(self, f"deconv{i}")(h)
            if i < self.n_deconvs - 1:
                h = self.hidden_activation(h)
        if self.output_activation is not None:
            h = self.output_activation(h)
        h = h.permute(0, 2, 3, 1)
        return h.reshape(tuple(lead) + tuple(h.shape[1:]))
