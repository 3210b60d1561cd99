from portbench import readers


def read(rec):
    return readers.rate(rec, "frames")
