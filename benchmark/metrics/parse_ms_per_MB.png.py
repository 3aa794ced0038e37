"""Host self time of the parse (``dbg.parse``: the container's headers, the
copies of its payload, the footer) in ms a decoded MB (PNG)."""

from benchmark import spans


def read(run):
    return spans.ms_per_MB(run, "parse")
