from portbench import spans


def read(rec):
    return spans.busy_share(rec, "s2p.style.noise")
