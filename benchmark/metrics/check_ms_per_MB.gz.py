"""Host self time of the checksums and size checks (``dbg.check``) in ms a
decoded MB (gzip)."""

from benchmark import spans


def read(run):
    return spans.ms_per_MB(run, "check")
