from portbench import readers


def read(rec):
    return readers.launches_per(rec, "steps")
