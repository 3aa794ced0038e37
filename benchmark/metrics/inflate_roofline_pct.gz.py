"""The device inflate's share of its bandwidth roofline on gzip traffic."""

from benchmark import readers


def read(run):
    return readers.inflate_roofline(run)
