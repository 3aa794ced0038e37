"""The unfilter kernel's share of its bandwidth roofline."""

from benchmark import readers


def read(run):
    return readers.unfilter_roofline(run)
