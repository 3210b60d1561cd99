"""How the benchmark builds the system under test (``s2p_tpu_torch``) from a
configuration and the harness's weights. Nothing else of the port is
imported outside the drivers."""

from __future__ import annotations

import torch

DTYPE = {"bf16": torch.bfloat16, "f32-tf32": torch.float32}  # a configuration's precision

GEN_KEYS = ("image_size", "ngf", "state_freqs", "state_embed_dim", "n_up", "mat_hidden",
            "mat_mode", "out_channels")


def generator_kwargs(cfg) -> dict:
    return {k: cfg[k] for k in GEN_KEYS}


def build_generator(cfg, weights: dict, device, dtype) -> torch.nn.Module:
    """The port's ``S2PGenerator`` in ``dtype`` holding ``weights``."""
    from s2p_tpu_torch.gan import S2PGenerator

    gen = S2PGenerator(cfg["state_dim"], device=device, **generator_kwargs(cfg)).to(dtype)
    gen.load_state_dict(weights, strict=True)
    return gen.requires_grad_(False)

