"""Autoregressive N-step generation with the generator module.

The port of ``s2p_tpu/gan/rollout.py``: take the image i_{t0} and states
s_{t0+1..t0+T}, and generate i_{t+1} = G(s_{t+1}, î_t) for T steps, each
step feeding the previous generated frame back in. The JAX ``lax.scan`` is
a loop over T.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def generate_rollout(generator: torch.nn.Module, init_image: torch.Tensor,
                     states: torch.Tensor) -> torch.Tensor:
    """init_image ``[B, H, W, C]`` in [-1, 1], states ``[T, B, S]`` →
    generated frames ``[T, B, H, W, C]`` in [-1, 1]."""
    frames = []
    img = init_image
    for s in states:
        img = generator(s, img)
        frames.append(img)
    return torch.stack(frames)
