"""The device inflate's share of its bandwidth roofline on PNG traffic."""

from benchmark import readers


def read(run):
    return readers.inflate_roofline(run)
