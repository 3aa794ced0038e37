"""``models/pipeline.decode_png_corpus_device``: a corpus of PNGs a call,
one (h, w, 4) RGBA array each in host memory (``as_numpy=True``), every
chunk's CRC-32 and each IDAT stream's Adler-32 checked."""

from __future__ import annotations


def call(pngs: list, device):
    from debigulator_tpu_torch.models import pipeline

    return pipeline.decode_png_corpus_device(
        pngs, verify_crc=True, verify_adler=True, as_numpy=True,
        device=device)


def outputs(result) -> list:
    """The call's outputs in the order of ``reference.expected``."""
    return list(result)
