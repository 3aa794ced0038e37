"""Host self time of staging (``dbg.stage``: packing, ``.pack``, and the copies
to the card, ``.h2d``) in ms a decoded MB (gzip)."""

from benchmark import spans


def read(run):
    return spans.ms_per_MB(run, "stage")
