"""The GAN → RL bridge: ``generate_images_for_dataset(rows, gen, batch_size,
bf16)`` (a ``mat`` generator renders on the fast path, ``fast_apply`` on
operands fused once a call; uint8 frames back on the host) in a closed
loop, ``rows_per_call`` rows a call.

Traffic: a host pool of ``pool_rows`` augment-schema rows (uint8
``image_observations``, float32 ``next_observations``) drawn from the seed
on the device in set-up, taken ``rows_per_call`` at a time in turn. The
comparison judges ``judged_rows`` rows, drawn from the seed, of one call
drawn from the seed.
"""

from __future__ import annotations

import torch

from portbench import compare, harness, program
from portbench.reference import nets
from portbench.reference.precision import Precision


class Bridge:
    latency = False

    def __init__(self, ctx: harness.Ctx):
        from s2p_tpu_torch.cli.generate_images import generate_images_for_dataset

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.render, self.ctx, self.batch = generate_images_for_dataset, ctx, tr["batch"]
        # the generator in the type the bridge runs, built once: given a float32
        # module, generate_images_for_dataset would copy it to bf16 every call
        dtype = program.DTYPE[cfg["precision"]]
        self.bf16 = dtype == torch.bfloat16
        self.weights = harness.seeded_weights(nets.generator_spec(cfg), ctx.generator("weights"),
                                              dev, dtype)
        self.gen = program.build_generator(cfg, self.weights, dev, dtype)
        N, H, C = tr["pool_rows"], cfg["image_size"], cfg["out_channels"]
        if N % tr["rows_per_call"]:
            raise ValueError(f"pool_rows {N} is not a whole number of calls of "
                             f"{tr['rows_per_call']} rows: a call would run past the pool")
        g = ctx.generator("traffic")
        self.images = torch.randint(0, 256, (N, H, H, C), generator=g, device=dev,
                                    dtype=torch.uint8).cpu().numpy()
        self.states = torch.randn(N, cfg["state_dim"], generator=g, device=dev).cpu().numpy()
        self.rows = tr["rows_per_call"]
        self.units = {"frames": self.rows, "passes": -(-self.rows // self.batch)}
        for i in range(tr["warmup_calls"]):
            self.run(i)
        self.keep = harness.Reservoir(1, harness.sub_seed(ctx.seed, "judge"))

    def run(self, i: int):
        lo = i * self.rows % len(self.states)
        rows = {"image_observations": self.images[lo:lo + self.rows],
                "next_observations": self.states[lo:lo + self.rows]}
        return lo, self.render(rows, self.gen, batch_size=self.batch, bf16=self.bf16)

    def call(self, i: int) -> dict:
        self.keep.offer(self.run(i))
        return self.units

    def finish(self) -> dict:
        (lo, frames), = self.keep.items
        g = torch.Generator().manual_seed(harness.sub_seed(self.ctx.seed, "judge rows"))
        idx = torch.randperm(self.rows, generator=g)[:self.ctx.traffic["judged_rows"]].numpy()
        judged = dict(weights=self.weights, prev=torch.from_numpy(self.images[lo + idx]),
                      states=torch.from_numpy(self.states[lo + idx]),
                      frames=torch.from_numpy(frames[idx]))
        del self.gen, self.keep
        return judged


def setup(ctx):
    return Bridge(ctx)


def check(ctx, judged, report=None) -> dict:
    return compare.uint8_gaps(ctx.config, judged["weights"], judged["prev"], judged["states"],
                              judged["frames"], ctx.device, ctx.traffic["check_chunk"], report)


def control(ctx, judged, kind: str, report=None) -> dict:
    """Readings with the reference in ``kind`` precision in the program's place."""
    frames = compare.reference_uint8(ctx.config, judged["weights"], judged["prev"],
                                     judged["states"], Precision(kind), ctx.device,
                                     ctx.traffic["check_chunk"])
    return check(ctx, dict(judged, frames=frames), report)
