from portbench import peaks, readers
from portbench.counts import slac_iql


def read(rec):
    n = rec["units"].get("steps")
    if not n:
        return None
    flops = n * slac_iql.train_step(rec["config"], rec["traffic"])
    return readers.mfu(flops, rec, peaks.TF32_FLOPS)
