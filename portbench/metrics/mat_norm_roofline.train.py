from portbench import readers


def read(rec):
    return readers.mat_norm_roofline(rec, "steps", {"forward": 2, "backward": 1})
