"""Semantic image synthesis: GauGAN's fast path ``synthesize_fast(gen, ids,
params)`` in a closed loop, frames left on the card.

Traffic: a pool of ``pool`` seeded label maps at the configuration's crop,
made on the device in set-up and used ``batch`` at a time in turn. Each map
is a Voronoi partition of the image into ``regions`` (8–32) cells from
seeded points, each cell a class drawn Zipf(``zipf_s``) over the semantic
classes (ADE20K's ids run by frequency). The weights: seeded convs, spectral
norm's vectors by power iteration, and running statistics from a train-mode
pass of the reference (``configs/<config>.json``'s ``weights`` and
``assumed``). The comparison judges ``judged_calls`` calls drawn from the
seed against the reference in float32 with TF32 off; ``control`` puts the
reference in fp8 (``fp8``), without its param-free norm (``no_norm``) or on
every label shifted by one class (``label_shift``) in the program's place.
"""

from __future__ import annotations

import math

from s2p_tpu_torch.gan import SPADEGenerator, fuse_fast_params, synthesize_fast

import torch
import torch.nn.functional as F

from portbench import harness, program
from portbench.reference import spade
from portbench.reference.precision import Precision, exact_f32

F32 = Precision("f32")
SATURATED = 0.99  # |frame| above this: tanh's flat tail, where gaps say little


def label_maps(n: int, hw, classes: int, regions, zipf_s: float, gen, device) -> torch.Tensor:
    """``n`` seeded Voronoi label maps ``[n, H, W]`` (uint8 ids < ``classes``)."""
    (H, W), (lo, hi) = hw, regions
    k = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
    points = torch.rand(n, hi, 2, generator=gen, device=device)
    probs = torch.arange(1, classes + 1, device=device, dtype=torch.float32) ** -zipf_s
    cls = torch.multinomial(probs, n * hi, replacement=True, generator=gen).view(n, hi)
    ys = (torch.arange(H, device=device, dtype=torch.float32) + 0.5) / H
    xs = (torch.arange(W, device=device, dtype=torch.float32) + 0.5) / W
    out = torch.empty(n, H, W, dtype=torch.uint8, device=device)
    for i in range(n):
        d = ((ys[:, None, None] - points[i, :, 0]).square()
             + (xs[None, :, None] - points[i, :, 1]).square())
        d[..., k[i]:] = math.inf  # only this map's first k points
        out[i] = cls[i, d.argmin(-1)].to(torch.uint8)
    return out


def seeded_weights(ctx) -> dict:
    """The configuration's weights in SPADE's names, f32 on the device."""
    opt, wcfg, dev = ctx.config["opt"], ctx.config["weights"], ctx.device
    snc = spade.semantic_nc(opt)
    spec = spade.conv_spec(opt)
    W = harness.seeded_weights(spec, ctx.generator("weights"), dev)
    for name in spec:  # the one-hot input's fan-in is the 9 taps
        if name == "fc.weight" or name.endswith("mlp_shared.0.weight"):
            W[name] *= math.sqrt(snc)
    g = ctx.generator("spectral")
    for name, shape in spec.items():
        if name.endswith(".weight_orig"):
            u0 = F.normalize(torch.randn(shape[0], generator=g, device=dev), dim=0)
            base = name[: -len("_orig")]
            W[base + "_u"], W[base + "_v"] = spade.power_iteration(W[name], u0,
                                                                    wcfg["power_iterations"])
    g = ctx.generator("statistics")
    tr = ctx.traffic
    batches = [spade.onehot(label_maps(wcfg["stat_batch"], spade.block_sizes(opt)[-1], snc,
                                       tr["regions"], tr["zipf_s"], g, dev), snc)
               for _ in range(wcfg["stat_batches"])]
    with exact_f32():
        W.update(spade.batch_statistics(W, opt, batches, F32))
    return W


def build_generator(opt, weights: dict, device, dtype) -> SPADEGenerator:
    """The port's ``SPADEGenerator`` in ``dtype`` holding ``weights`` (SPADE's names)."""
    from s2p_tpu_torch.gan.convert import state_dict_from_spade

    gen = SPADEGenerator(**opt, device=device)
    gen.load_state_dict(state_dict_from_spade(weights), strict=True)
    return gen.to(dtype).eval().requires_grad_(False)


class Synthesis:
    latency = False

    def __init__(self, ctx: harness.Ctx):
        opt, tr, dev = ctx.config["opt"], ctx.traffic, ctx.device
        if tr["pool"] % tr["batch"]:
            raise ValueError(f"a pool of {tr['pool']} maps does not split into calls of "
                             f"{tr['batch']}")
        self.weights = seeded_weights(ctx)
        if dev.type == "cuda":  # the statistics pass is done and freed: peak from serving on
            torch.cuda.reset_peak_memory_stats(dev)
        self.gen = build_generator(opt, self.weights, dev, program.DTYPE[ctx.config["precision"]])
        self.params = fuse_fast_params(self.gen)
        self.pool = label_maps(tr["pool"], self.gen.image_hw, self.gen.semantic_nc, tr["regions"],
                               tr["zipf_s"], ctx.generator("traffic"), dev)
        self.batch = tr["batch"]
        self.units = {"frames": self.batch, "passes": 1}
        for i in range(tr["warmup_calls"]):
            self.run(i)
        self.keep = harness.Reservoir(tr["judged_calls"], harness.sub_seed(ctx.seed, "judge"))

    def ids(self, i: int) -> torch.Tensor:
        lo = (i * self.batch) % len(self.pool)
        return self.pool[lo:lo + self.batch]

    def run(self, i: int) -> torch.Tensor:
        return synthesize_fast(self.gen, self.ids(i), self.params)

    def call(self, i: int) -> dict:
        self.keep.offer((self.ids(i), self.run(i)))
        return self.units

    def finish(self) -> dict:
        judged = list(self.keep.items)
        weights = self.weights
        del self.gen, self.params, self.keep
        return dict(weights=weights, calls=judged)


def setup(ctx):
    return Synthesis(ctx)


@torch.no_grad()
def reference_frames(ctx, weights: dict, ids: torch.Tensor, prec: Precision,
                     param_free=None, shift: int = 0) -> torch.Tensor:
    """The reference's frames of label maps ``ids``, in chunks of rows;
    ``shift`` adds to every label (mod the classes)."""
    opt, chunk = ctx.config["opt"], ctx.traffic["check_chunk"]
    snc = spade.semantic_nc(opt)
    W = prec.cast({k: v.to(ctx.device, torch.float32) for k, v in weights.items()})
    out = []
    with exact_f32():
        for lo in range(0, len(ids), chunk):
            lab = (ids[lo:lo + chunk].to(ctx.device).long() + shift) % snc
            out.append(spade.generator(W, opt, spade.onehot(lab, snc, prec.dtype), prec,
                                       param_free))
    return torch.cat(out)


def check(ctx, judged, report=None) -> dict:
    """``frame_max_gap``: the widest |frame − reference| over every value of
    every judged frame; ``frame_rms_gap``: their root mean square. ``report``
    gets ``saturated_share``, the share of frame values beyond ±0.99."""
    worst, sq, n, sat = 0.0, 0.0, 0, 0
    for ids, frames in judged["calls"]:
        ref = reference_frames(ctx, judged["weights"], ids, F32)
        err = frames.to(ctx.device).float() - ref
        worst = max(worst, err.abs().max().item())
        sq += err.square().sum().item()
        n += err.numel()
        sat += (frames.float().abs() > SATURATED).sum().item()
    if report is not None:
        report["saturated_share"] = sat / n
    return {"frame_max_gap": worst, "frame_rms_gap": math.sqrt(sq / n)}


CONTROLS = {"fp8": dict(prec=Precision("fp8")), "no_norm": dict(param_free="none"),
            "label_shift": dict(shift=1)}


def control(ctx, judged, kind: str, report=None) -> dict:
    """Readings with the reference in ``kind`` (``CONTROLS``) in the program's place."""
    kw = dict(CONTROLS[kind])
    prec = kw.pop("prec", F32)
    calls = [(ids, reference_frames(ctx, judged["weights"], ids, prec, **kw))
             for ids, _ in judged["calls"]]
    return check(ctx, dict(weights=judged["weights"], calls=calls), report)
