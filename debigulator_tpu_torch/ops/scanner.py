"""Host-side DEFLATE stream scanner: block index, code lengths and exact
per-cell decoder entries (the port of debigulator_tpu/ops/scanner.py).

Finding where block k+1 starts requires decoding block k, so an exact
index is one serial pass; the native C++ scanner does it on the host while
all symbol and LZ77 work runs on the card.  Native only in this slice.
"""

from __future__ import annotations

from debigulator_tpu_torch.native import scanner as native_scanner


def scan_stream_cells(data, cell_bits: int):
    """Index + exact per-cell decoder entry states.

    Returns (blocks, lengths, cells) with cells = (states int64 array,
    pend int32 array, mct int) in the virtual cell layout of ops.plan —
    mct is the scanner's exact per-cell token bound (the most tokens any
    single cell decodes), which picks the tape slot count.
    """
    return native_scanner.scan_stream(bytes(memoryview(data)),
                                      cell_bits=cell_bits)
