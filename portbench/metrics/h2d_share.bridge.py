from portbench import readers


def read(rec):
    return readers.htod_share(rec)
