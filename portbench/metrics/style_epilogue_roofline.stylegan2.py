"""The demodulating style-epilogue kernel's Σ bound ÷ Σ device time over a
traced window's StyleGAN2 passes (17 launches a pass), in %; None when the
trace's launches are not 17 a pass (a program without the kernel, or
another path)."""

from portbench import readers
from portbench.counts import stylegan2


def read(rec):
    if not rec.get("trace") or not rec["units"].get("passes") or "G" not in rec["config"]:
        return None
    cfg, passes = rec["config"], rec["units"]["passes"]
    hits = [v for k, v in rec["trace"]["ops"].items() if stylegan2.DEMOD_KERNEL in k]
    count, seconds = sum(c for c, _ in hits), sum(s for _, s in hits)
    if count != passes * stylegan2.launches(cfg["G"]) or seconds <= 0:
        return None
    bound = passes * stylegan2.epilogue_bound_s(cfg["G"], rec["traffic"]["batch"],
                                                readers.ITEMSIZE[cfg["precision"]])
    return 100.0 * bound / seconds
