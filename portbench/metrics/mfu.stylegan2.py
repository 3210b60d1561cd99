from portbench import readers
from portbench.counts import stylegan2


def read(rec):
    n = rec["units"].get("frames")
    return readers.mfu(n * stylegan2.generator_forward(rec["config"]["G"], 1), rec) if n else None
