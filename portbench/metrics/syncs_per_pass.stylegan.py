from portbench import spans


def read(rec):
    return spans.syncs_per_pass(rec)
