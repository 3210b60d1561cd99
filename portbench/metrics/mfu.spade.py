from portbench import readers
from portbench.counts import spade


def read(rec):
    n = rec["units"].get("frames")
    return readers.mfu(n * spade.generator_forward(rec["config"]["opt"], 1), rec) if n else None
