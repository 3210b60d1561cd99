from portbench import readers
from portbench.counts import stylegan


def read(rec):
    n = rec["units"].get("frames")
    return readers.mfu(n * stylegan.generator_forward(rec["config"]["G"], 1), rec) if n else None
