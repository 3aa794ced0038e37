"""``models/pipeline.decode_png_device``: one PNG a call (the pool item's
one image), (h, w, 4) RGBA in host memory, every chunk's CRC-32 and the
IDAT stream's Adler-32 checked."""

from __future__ import annotations


def call(pngs: list, device):
    from debigulator_tpu_torch.models import pipeline

    (png,) = pngs
    return pipeline.decode_png_device(png, verify_crc=True,
                                      verify_adler=True, device=device)


def outputs(result) -> list:
    """The call's outputs in the order of ``reference.expected``."""
    return [result]
