from portbench import readers


def read(rec):
    return readers.mat_norm_roofline(rec, "passes", {"forward": 1})
