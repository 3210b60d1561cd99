"""The SPADE-norm kernel's Σ bound ÷ Σ device time over a traced window's
passes, in %; None when the trace's launches are not the count the shapes
give (a program without the kernel, or another path)."""

from portbench import readers
from portbench.counts import spade


def read(rec):
    if not rec.get("trace") or not rec["units"].get("passes"):
        return None
    cfg, passes = rec["config"], rec["units"]["passes"]
    hits = [v for k, v in rec["trace"]["ops"].items() if spade.KERNEL in k]
    count, seconds = sum(c for c, _ in hits), sum(s for _, s in hits)
    if count != passes * spade.launches(cfg["opt"]) or seconds <= 0:
        return None
    bound = passes * spade.bound_s(cfg["opt"], rec["traffic"]["batch"],
                                   readers.ITEMSIZE[cfg["precision"]])
    return 100.0 * bound / seconds
