"""Interactive generation: one client's rollouts through the module path,
``generate_rollout(gen, init, states)``, each from host inputs to frames
back on the host (its latency).

Traffic: ``pool`` rollouts of ``batch`` rows × ``seq_len`` states and their
initial frames, drawn from the seed in set-up and held on the host, used in
turn. The comparison judges ``judged_calls`` calls drawn from the seed.
"""

from __future__ import annotations

import torch

from portbench import compare, harness, program
from portbench.reference import nets
from portbench.reference.precision import Precision


class Rollout:
    latency = True

    def __init__(self, ctx: harness.Ctx):
        from s2p_tpu_torch.gan import generate_rollout

        cfg, tr, self.dev = ctx.config, ctx.traffic, ctx.device
        dtype = program.DTYPE[cfg["precision"]]
        self.rollout, self.ctx = generate_rollout, ctx
        self.weights = harness.seeded_weights(nets.generator_spec(cfg), ctx.generator("weights"),
                                              self.dev, dtype)
        self.gen = program.build_generator(cfg, self.weights, self.dev, dtype)
        P, T, B, H = tr["pool"], tr["seq_len"], tr["batch"], cfg["image_size"]
        g = ctx.generator("traffic")
        self.states = torch.randn(P, T, B, cfg["state_dim"], generator=g, device=self.dev
                                  ).to(dtype).cpu()
        self.init = (torch.rand(P, B, H, H, cfg["out_channels"], generator=g, device=self.dev)
                     * 2 - 1).to(dtype).cpu()
        self.units = {"frames": B * T, "passes": T, "rollouts": 1}
        for i in range(tr["warmup_calls"]):
            self.run(i)
        self.keep = harness.Reservoir(tr["judged_calls"], harness.sub_seed(ctx.seed, "judge"))

    def run(self, i: int) -> torch.Tensor:
        p = i % len(self.states)
        with self.ctx.span("rollout.h2d"):
            init, states = self.init[p].to(self.dev), self.states[p].to(self.dev)
        frames = self.rollout(self.gen, init, states)
        with self.ctx.span("rollout.d2h"):
            return frames.cpu()

    def call(self, i: int) -> dict:
        self.keep.offer((i % len(self.states), self.run(i)))
        return self.units

    def finish(self) -> dict:
        judged = [(self.init[p], self.states[p], frames) for p, frames in self.keep.items]
        weights = self.weights
        del self.gen, self.keep
        return dict(weights=weights, rollouts=judged)


def setup(ctx):
    return Rollout(ctx)


def check(ctx, judged) -> dict:
    return compare.rollout_gaps(ctx.config, judged["weights"], judged["rollouts"], ctx.device,
                                ctx.traffic["check_chunk"])


def control(ctx, judged, kind: str) -> dict:
    """Readings with the reference in ``kind`` precision in the program's place."""
    rollouts = compare.reference_rollouts(ctx.config, judged["weights"], judged["rollouts"],
                                          Precision(kind), ctx.device, ctx.traffic["check_chunk"])
    return check(ctx, dict(weights=judged["weights"], rollouts=rollouts))
