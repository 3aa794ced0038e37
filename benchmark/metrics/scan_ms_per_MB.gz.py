"""Host self time of the host scan (``dbg.scan``) in ms a decoded MB (gzip)."""

from benchmark import spans


def read(run):
    return spans.ms_per_MB(run, "scan")
