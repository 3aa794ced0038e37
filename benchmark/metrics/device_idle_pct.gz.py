"""The share of the traced window in which the card ran nothing (gzip)."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
