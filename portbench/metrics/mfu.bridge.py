from portbench import readers


def read(rec):
    return readers.mfu_gen(rec)
