"""Kernel launches a MB of decoded text: the inflate's glue and the entry's
fixed cost a call."""

from benchmark import readers


def read(run):
    return readers.launches_per_MB(run)
