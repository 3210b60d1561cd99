"""Style-based synthesis with StyleGAN2: ``synthesize_style_fast(gen, z,
noise_gen, params)`` on a ``StyleGAN2Generator`` in a closed loop, frames
left on the card.

Traffic and judging as ``stylegan_synth``'s (a pool of seeded latents used
``batch`` at a time, each call's noise from a generator seeded for that call,
``judged_calls`` calls against the reference in float32 with TF32 off, gaps
÷ the reference frames' range), with StyleGAN2's weights and reference
(``reference/stylegan2.py``, the official fused modulated convs); a
``control`` puts in the program's place the reference in fp8 (``fp8``),
without demodulation (``no_demod``), with every noise strength zeroed
(``no_noise``), at ψ = 1 (``psi1``) or with nearest upsampling in place of
the FIR (``nearest``).
"""

from __future__ import annotations

import math

from s2p_tpu_torch.gan import StyleGAN2Generator, fuse_fast_params

import torch

from portbench import harness, program
from portbench.drivers import stylegan_synth
from portbench.drivers.stylegan_synth import noise_seed
from portbench.reference import stylegan2 as ref
from portbench.reference.precision import Precision, exact_f32

F32 = Precision("f32")


def seeded_weights(ctx) -> dict:
    """The configuration's weights in the official names, f32 on the device:
    conv, toRGB and style weights N(0, 1) and mapping weights N(0, 1/lrmul²)
    (the official init's), the constant N(0, 1), biases, mod biases and noise
    strengths at the configuration's ``bias_std``/``mod_bias_std``/
    ``noise_std`` (run-time scale), then ``dlatent_avg`` from the mapping."""
    G, wc, dev = ctx.config["G"], ctx.config["weights"], ctx.device
    lrmul = G["mapping_lrmul"]
    std = {"mapping_weight": 1.0 / lrmul, "weight": 1.0, "mod_weight": 1.0, "const": 1.0,
           "mapping_bias": wc["bias_std"] / lrmul, "bias": wc["bias_std"],
           "mod_bias": wc["mod_bias_std"], "noise": wc["noise_std"]}
    spec = ref.param_spec(G)
    total = sum(math.prod(shape) for shape, _ in spec.values())
    flat = torch.randn(total, generator=ctx.generator("weights"), device=dev)
    W, off = {}, 0
    for name, (shape, kind) in spec.items():
        n = math.prod(shape)
        W[name] = flat[off:off + n].view(shape) * std[kind]
        off += n
    with exact_f32():
        W["dlatent_avg"] = ref.dlatent_mean(W, G, wc["dlatent_avg_samples"],
                                            ctx.generator("dlatent_avg"), dev, F32)
    return W


def build_generator(G, weights: dict, device, dtype) -> StyleGAN2Generator:
    """The port's ``StyleGAN2Generator`` in ``dtype`` holding ``weights``
    (official names, '/' read as '.')."""
    gen = StyleGAN2Generator(**G, device=device)
    gen.load_state_dict({k.replace("/", "."): v for k, v in weights.items()}, strict=True)
    return gen.to(dtype).eval().requires_grad_(False)


class Synthesis(stylegan_synth.Synthesis):
    """``stylegan_synth``'s closed loop on a StyleGAN2 generator."""

    def __init__(self, ctx: harness.Ctx):
        G, tr, dev = ctx.config["G"], ctx.traffic, ctx.device
        if tr["pool"] % tr["batch"]:
            raise ValueError(f"a pool of {tr['pool']} latents does not split into calls of "
                             f"{tr['batch']}")
        self.ctx = ctx
        self.weights = seeded_weights(ctx)
        self.gen = build_generator(G, self.weights, dev, program.DTYPE[ctx.config["precision"]])
        self.params = fuse_fast_params(self.gen)
        self.pool = torch.randn(tr["pool"], G["latent_size"], generator=ctx.generator("traffic"),
                                device=dev)
        self.noise_gen = torch.Generator(device=dev)
        self.batch = tr["batch"]
        self.units = {"frames": self.batch, "passes": 1}
        for i in range(tr["warmup_calls"]):
            self.run(i)
        self.keep = harness.Reservoir(tr["judged_calls"], harness.sub_seed(ctx.seed, "judge"))


def setup(ctx):
    return Synthesis(ctx)


@torch.no_grad()
def reference_frames(ctx, weights: dict, call: int, z: torch.Tensor, prec: Precision,
                     **kw) -> torch.Tensor:
    """The reference's frames of call ``call``'s latents ``z``, with that
    call's noise, in chunks of rows; ``kw`` goes to ``reference.generator``."""
    G, chunk, dev = ctx.config["G"], ctx.traffic["check_chunk"], ctx.device
    noise = ref.noise_maps(len(z), G, torch.Generator(device=dev).manual_seed(
        noise_seed(ctx, call)), dev)
    W = prec.cast({k: v.to(dev, torch.float32) for k, v in weights.items()})
    out = []
    with exact_f32():
        for lo in range(0, len(z), chunk):
            rows = slice(lo, lo + chunk)
            out.append(ref.generator(W, G, z[rows].to(dev, prec.dtype),
                                     [n[rows] for n in noise], prec, **kw).float())
    return torch.cat(out)


def check(ctx, judged) -> dict:
    """``frame_max_gap``: the widest |frame − reference| over every value of
    every judged frame; ``frame_rms_gap``: their root mean square; each ÷
    the range (max − min) of the reference's values."""
    worst, sq, n, lo, hi = 0.0, 0.0, 0, math.inf, -math.inf
    for call, z, frames in judged["calls"]:
        want = reference_frames(ctx, judged["weights"], call, z, F32)
        err = frames.to(ctx.device).float() - want
        worst = max(worst, err.abs().max().item())
        sq += err.square().sum().item()
        n += err.numel()
        lo, hi = min(lo, want.min().item()), max(hi, want.max().item())
        del want, err
    span = hi - lo
    return {"frame_max_gap": worst / span, "frame_rms_gap": math.sqrt(sq / n) / span}


CONTROLS = {"fp8": dict(prec=Precision("fp8")), "no_demod": dict(demodulate=False),
            "no_noise": dict(use_noise=False), "psi1": dict(psi=1.0),
            "nearest": dict(fir_on=False)}


def control(ctx, judged, kind: str) -> dict:
    """Readings with the reference under ``kind`` (``CONTROLS``) in the program's place."""
    kw = dict(CONTROLS[kind])
    prec = kw.pop("prec", F32)
    calls = [(call, z, reference_frames(ctx, judged["weights"], call, z, prec, **kw))
             for call, z, _ in judged["calls"]]
    return check(ctx, dict(weights=judged["weights"], calls=calls))
