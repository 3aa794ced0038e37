"""Host self time of the read-back (``dbg.readback``: the copies to the host,
RGBA expansion, the joined output) in ms a decoded MB (gzip)."""

from benchmark import spans


def read(run):
    return spans.ms_per_MB(run, "readback")
