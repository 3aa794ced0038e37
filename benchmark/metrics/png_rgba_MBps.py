"""RGBA bytes every call in the window delivered to host memory, in MB a second
of the window."""

from benchmark import readers


def read(run):
    return readers.delivered_MBps(run)
