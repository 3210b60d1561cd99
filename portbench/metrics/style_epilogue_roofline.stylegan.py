"""The style-epilogue kernel's Σ bound ÷ Σ device time over a traced
window's StyleGAN passes (18 launches a pass), in %; None when the trace's
launches are not 18 a pass (a program without the kernel, or another path)."""

from portbench import readers
from portbench.counts import stylegan


def read(rec):
    if not rec.get("trace") or not rec["units"].get("passes") or "G" not in rec["config"]:
        return None
    cfg, passes = rec["config"], rec["units"]["passes"]
    hits = [v for k, v in rec["trace"]["ops"].items() if stylegan.EPILOGUE_KERNEL in k]
    count, seconds = sum(c for c, _ in hits), sum(s for _, s in hits)
    if count != passes * stylegan.launches(cfg["G"]) or seconds <= 0:
        return None
    bound = passes * stylegan.epilogue_bound_s(cfg["G"], rec["traffic"]["batch"],
                                               readers.ITEMSIZE[cfg["precision"]])
    return 100.0 * bound / seconds
