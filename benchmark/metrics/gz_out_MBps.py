"""Decoded bytes of every call in the window, in MB a second of the window."""

from benchmark import readers


def read(run):
    return readers.delivered_MBps(run)
