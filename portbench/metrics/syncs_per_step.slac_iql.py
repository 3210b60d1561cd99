from portbench import spans


def read(rec):
    return spans.syncs_per(rec, "steps")
