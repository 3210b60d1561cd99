"""Model FLOPs of one IQL + SLAC step, counted from the configuration's shapes.

Two FLOPs a multiply-accumulate of every convolution (all taps, padding
included), transposed convolution (every input pixel times every tap) and
linear layer, forward and backward as the step computes them: a backward
costs its forward twice where the layer's input needs a gradient too and
once where only its weights do (the encoder's first conv on frames; the
critics' and the policy's first layers on the latent, sampled without
gradients). ``tests/test_portbench_slac_iql.py`` holds this count to
``torch.utils.flop_counter.FlopCounterMode`` over the reference's step.

- the RL step: the encoder over ``batch`` windows of S + 1 frames and the
  posterior (no gradients); Q1, Q2 and V on z, V on z′ and both target Qs;
  the policy; the backward of the Qs, V and the policy;
- the ELBO step on ``batch_size_latent`` windows: encoder, posterior, the
  z1 prior, decoder and reward head, forward and backward.
"""

from __future__ import annotations

from typing import List, Sequence

from portbench.counts.flops import conv, linear
from portbench.reference import slac_iql as ref


def _mlp(batch: int, widths: Sequence[int]) -> List[int]:
    return [linear(batch, i, o) for i, o in zip(widths[:-1], widths[1:])]


def _backward(layers: List[int], input_grad: bool) -> int:
    return 2 * sum(layers) - (0 if input_grad else layers[0])


def _head(cfg, name: str, batch: int) -> List[int]:
    i, o = ref.head_io(cfg)[name]
    return _mlp(batch, [i, *cfg["slac"]["hidden_units"], 2 * o])


def encoder(cfg, frames: int) -> List[int]:
    return [conv(frames, ci, co, k, size) for ci, co, k, _, _, size in ref.encoder_layers(cfg)]


def decoder(cfg, frames: int) -> List[int]:
    return [2 * frames * ci * co * k * k * size * size
            for ci, co, k, _, _, _, size in ref.decoder_layers(cfg)]


def posterior(cfg, batch: int) -> int:
    per_step = sum(_head(cfg, "z1_posterior", batch)) + sum(_head(cfg, "z2_prior", batch))
    return (sum(_head(cfg, "z1_posterior_init", batch)) + sum(_head(cfg, "z2_prior_init", batch))
            + cfg["num_sequences"] * per_step)


def rl_step(cfg, batch: int) -> int:
    S, A, z = cfg["num_sequences"], cfg["action_dim"], ref.z_dim(cfg)
    q_hidden, p_hidden = cfg["iql"]["critic_hidden"], cfg["iql"]["policy_hidden"]
    q = _mlp(batch, [z + A, *q_hidden, 1])
    v = _mlp(batch, [z, *q_hidden, 1])
    trunk = _mlp(batch, [ref.feature_action_dim(cfg), *p_hidden])
    pi = trunk + 2 * _mlp(batch, [p_hidden[-1], A])
    forward = (sum(encoder(cfg, batch * (S + 1))) + posterior(cfg, batch)
               + 4 * sum(q) + 2 * sum(v) + sum(pi))
    return forward + 2 * _backward(q, False) + _backward(v, False) + _backward(pi, False)


def latent_step(cfg, batch: int) -> int:
    S = cfg["num_sequences"]
    enc, dec = encoder(cfg, batch * (S + 1)), decoder(cfg, batch * (S + 1))
    rest = (posterior(cfg, batch) + sum(_head(cfg, "z1_prior", batch * S))
            + sum(_head(cfg, "reward", batch * S)))
    return sum(enc) + sum(dec) + rest + _backward(enc, False) + 2 * sum(dec) + 2 * rest


def train_step(cfg, traffic) -> int:
    return rl_step(cfg, traffic["batch"]) + latent_step(cfg, cfg["slac"]["batch_size_latent"])
