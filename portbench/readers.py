"""What the metric readers in ``metrics/`` share. Each returns None when the
run holds nothing to read, and the metric is then left out of the line."""

from __future__ import annotations

import statistics

from portbench import peaks
from portbench.counts import flops, mat_norm

ITEMSIZE = {"bf16": 2, "f32-tf32": 4}


def rate(rec, unit: str):
    n = rec["units"].get(unit)
    return n / rec["window_s"] if n else None


def p95_ms(rec):
    lat = rec["latencies_s"]
    return 1e3 * statistics.quantiles(lat, n=20)[-1] if len(lat) >= 20 else None


def share(seconds: float, rec) -> float:
    return 100.0 * seconds / rec["trace"]["window_s"]


def idle_share(rec):
    if not rec.get("trace"):
        return None
    return 100.0 - share(rec["trace"]["busy_s"], rec)


def htod_share(rec):
    return share(rec["trace"]["htod_s"], rec) if rec.get("trace") else None


def launches_per(rec, unit: str):
    n = rec["units"].get(unit)
    return rec["trace"]["kernels"] / n if rec.get("trace") and n else None


def mfu(model_flops: float, rec, peak: float = peaks.BF16_FLOPS):
    return 100.0 * model_flops / (rec["window_s"] * peak)


def mfu_gen(rec):
    n = rec["units"].get("frames")
    return mfu(n * flops.generator_forward(rec["config"], 1), rec) if n else None


def mfu_train(rec):
    n = rec["units"].get("steps")
    return mfu(n * flops.train_step(rec["config"], rec["traffic"]["batch"]), rec) if n else None


def kernel_time(rec, direction: str):
    """(launches, seconds) of the MAT-norm kernel in ``direction`` in the trace."""
    hits = [v for k, v in rec["trace"]["ops"].items() if mat_norm.KERNEL[direction] in k
            and (direction == "backward" or mat_norm.KERNEL["backward"] not in k)]
    return sum(c for c, _ in hits), sum(s for _, s in hits)


def mat_norm_roofline(rec, unit: str, passes: dict):
    """Σ bound ÷ Σ device time over the directions in ``passes``: generator
    passes at the traffic's batch per ``unit`` of work (a generation call
    counts its passes; a train step makes 2 forward and 1 backward); None
    if the trace's launches are not the count the shapes give."""
    if not rec.get("trace") or not rec["units"].get(unit):
        return None
    cfg, traffic = rec["config"], rec["traffic"]
    batch, itemsize = traffic["batch"], ITEMSIZE[cfg["precision"]]
    bound = spent = 0.0
    for direction, per_unit in passes.items():
        n_pass = rec["units"][unit] * per_unit
        count, seconds = kernel_time(rec, direction)
        if count != n_pass * mat_norm.launches(cfg) or seconds <= 0:
            return None
        bound += n_pass * mat_norm.bound_s(cfg, direction, batch, itemsize)
        spent += seconds
    return 100.0 * bound / spent
