"""Published peaks of the chip, and the work counts that rooflines divide by
them.

NVIDIA H100 SXM data sheet, dense rates: 80 GB of HBM3 at 3.35 TB/s.
The card's power limit (700 W at full rate) is printed beside every run's
result, since a card set lower runs slower under load.
"""

from __future__ import annotations

#: Bytes a second of one H100's HBM3.
HBM_BYTES_PER_S = 3.35e12


def inflate_bytes(item) -> int:
    """An inflate's least traffic: the compressed bytes read once and the
    inflated bytes (text or filtered scanlines) written once."""
    return item.in_bytes + item.inflated_bytes


def unfilter_bytes(item) -> int:
    """An unfilter's least traffic: the filtered scanlines read once and
    the samples written once."""
    return item.filtered_bytes + item.raw_bytes


def roofline_pct(bytes_moved: float, device_us: float) -> float | None:
    """The share, in percent, of the bandwidth roofline that ``device_us``
    of device time reaches on ``bytes_moved``: the least time the bytes
    need at the peak over the time taken.  None where nothing ran."""
    if device_us <= 0 or bytes_moved <= 0:
        return None
    return 100.0 * (bytes_moved / HBM_BYTES_PER_S) / (device_us * 1e-6)
