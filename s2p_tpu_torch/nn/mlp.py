"""MLP building blocks.

The port of ``s2p_tpu/nn/mlp.py``: fan-in uniform hidden kernels, constant
hidden biases (``b_init_value``), a U(−init_w, init_w) last layer, optional
LayerNorm on every hidden layer but the last (the reference's quirk,
rlkit mlp.py:63-64), configurable hidden and output activations, and
``ConcatMlp``, which concatenates its inputs along the last axis (the Q/V
critic entry point). Module names are flax's (``fc{i}``, ``layer_norm{i}``,
``last_fc``, ``head{j}``); LayerNorm's ε is flax's 1e-6.

Weights come from ``gen`` (a CPU ``torch.Generator``) or, without one,
from ``torch.Generator().manual_seed(seed)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2p_tpu_torch.nn.initializers import fanin_uniform_, uniform_

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


def init_generator(gen: Optional[torch.Generator], seed: int) -> torch.Generator:
    return gen if gen is not None else torch.Generator().manual_seed(seed)


class Mlp(nn.Module):
    def __init__(self, input_size: int, hidden_sizes: Sequence[int], output_size: int,
                 init_w: float = 3e-3, hidden_activation: Callable = F.relu,
                 output_activation: Optional[Callable] = None, b_init_value: float = 0.0,
                 layer_norm: bool = False, gen: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__()
        gen = init_generator(gen, seed)
        self.hidden_activation, self.output_activation = hidden_activation, output_activation
        self.n_hidden = len(hidden_sizes)
        self.layer_norm = layer_norm
        prev = input_size
        for i, size in enumerate(hidden_sizes):
            fc = nn.Linear(prev, size)
            fanin_uniform_(fc.weight, gen)
            nn.init.constant_(fc.bias, b_init_value)
            self.add_module(f"fc{i}", fc)
            if layer_norm and i < self.n_hidden - 1:
                self.add_module(f"layer_norm{i}", nn.LayerNorm(size, eps=LAYER_NORM_EPS))
            prev = size
        self.last_fc = nn.Linear(prev, output_size)
        uniform_(self.last_fc.weight, init_w, gen)
        nn.init.zeros_(self.last_fc.bias)

    def forward(self, x: torch.Tensor, return_preactivations: bool = False):
        h = x
        for i in range(self.n_hidden):
            h = getattr(self, f"fc{i}")(h)
            if self.layer_norm and i < self.n_hidden - 1:
                h = getattr(self, f"layer_norm{i}")(h)
            h = self.hidden_activation(h)
        pre = self.last_fc(h)
        out = self.output_activation(pre) if self.output_activation else pre
        if return_preactivations:
            return out, pre
        return out


class ConcatMlp(Mlp):
    """Mlp over ``cat(*inputs, dim=-1)``."""

    def forward(self, *inputs: torch.Tensor, **kwargs):
        return super().forward(torch.cat(inputs, dim=-1), **kwargs)


class MultiHeadedMlp(nn.Module):
    """A shared trunk with one linear head per output size."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 output_sizes: Sequence[int], init_w: float = 3e-3,
                 hidden_activation: Callable = F.relu, layer_norm: bool = False,
                 gen: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        gen = init_generator(gen, seed)
        self.hidden_activation = hidden_activation
        self.n_hidden, self.n_heads = len(hidden_sizes), len(output_sizes)
        self.layer_norm = layer_norm
        prev = input_size
        for i, size in enumerate(hidden_sizes):
            fc = nn.Linear(prev, size)
            fanin_uniform_(fc.weight, gen)
            nn.init.zeros_(fc.bias)
            self.add_module(f"fc{i}", fc)
            if layer_norm and i < self.n_hidden - 1:
                self.add_module(f"layer_norm{i}", nn.LayerNorm(size, eps=LAYER_NORM_EPS))
            prev = size
        for j, out in enumerate(output_sizes):
            head = nn.Linear(prev, out)
            uniform_(head.weight, init_w, gen)
            nn.init.zeros_(head.bias)
            self.add_module(f"head{j}", head)

    def forward(self, x: torch.Tensor):
        h = x
        for i in range(self.n_hidden):
            h = getattr(self, f"fc{i}")(h)
            if self.layer_norm and i < self.n_hidden - 1:
                h = getattr(self, f"layer_norm{i}")(h)
            h = self.hidden_activation(h)
        return tuple(getattr(self, f"head{j}")(h) for j in range(self.n_heads))

