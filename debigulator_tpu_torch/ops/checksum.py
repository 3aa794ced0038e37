"""Host CRC-32 (gzip flavour) through the native library.

Device checksums (the GF(2) lane-parallel forms of
debigulator_tpu/ops/checksum.py) are a later slice of the port.
"""

from __future__ import annotations

from debigulator_tpu_torch.native import scanner as _native


def crc32(data, crc: int = 0) -> int:
    """CRC-32 of a bytes-like object (native slice-by-8)."""
    return _native.crc32(data, crc)
