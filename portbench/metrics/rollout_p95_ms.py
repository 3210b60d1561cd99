from portbench import readers


def read(rec):
    return readers.p95_ms(rec)
