"""Host-side DEFLATE stream scanner: block index, code lengths and exact
per-cell decoder entries (the port of debigulator_tpu/ops/scanner.py).

Finding where block k+1 starts requires decoding block k, so an exact
index is one serial pass; the native C++ scanner does it on the host while
all symbol and LZ77 work runs on the card.  With ``DBG_NO_NATIVE=1`` the
pass is the Python inflate of ops.inflate_ref instead: it gives the block
index and code lengths but no per-cell entries (``cells=None``), and the
decode drivers then find the entries themselves with the speculative
fixpoint of ops.graph.  Only the variable selects the Python scan; a
native library that cannot be built raises.

The scans read their stream where it lies: ``data`` may be any contiguous
buffer (bytes, bytearray, a memoryview slice, a NumPy uint8 array), and
bytes after the stream's final block are neither copied nor read, so a
caller may hand in the rest of a file.  ``scan_stream_cells`` counts what
it is handed and what it reads (the ``.launches`` style):
``scan_stream_cells.calls``, ``.bytes_given`` (the lengths handed in) and
``.bytes_read`` (up to each final block's ``end_bit``, rounded up to
bytes).
"""

from __future__ import annotations

import threading

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch import native
from debigulator_tpu_torch.native import scanner as native_scanner
from debigulator_tpu_torch.ops.inflate_ref import (
    BlockInfo,
    _BitReader,
    inflate,
    read_dynamic_lengths,
)


def scan_stream(data) -> tuple[list[BlockInfo], list]:
    """Index a raw DEFLATE stream.

    Returns (blocks, lengths) where lengths[b] is (litlen_lengths,
    dist_lengths) for Huffman blocks and None for stored blocks.
    """
    if native.disabled():
        return _scan_stream_py(data)
    return native_scanner.scan_stream(data)


def scan_stream_cells(data, cell_bits: int):
    """Index + exact per-cell decoder entry states.

    Returns (blocks, lengths, cells) with cells = (states int64 array,
    pend int32 array, mct int) in the virtual cell layout of ops.plan —
    mct is the scanner's exact per-cell token bound (the most tokens any
    single cell decodes), which picks the tape slot count — or cells=None
    from the Python scan (callers then run the speculative entry fixpoint).
    """
    if native.disabled():
        blocks, lengths = _scan_stream_py(data)
        scanned = blocks, lengths, None
    else:
        scanned = native_scanner.scan_stream(data, cell_bits=cell_bits)
    given = memoryview(data).nbytes
    read = (scanned[0][-1].end_bit + 7) // 8
    with _COUNT_LOCK:  # the corpus and merged scans run on worker threads
        scan_stream_cells.calls += 1
        scan_stream_cells.bytes_given += given
        scan_stream_cells.bytes_read += read
    return scanned


_COUNT_LOCK = threading.Lock()
scan_stream_cells.calls = 0
scan_stream_cells.bytes_given = 0
scan_stream_cells.bytes_read = 0


def scan_stream_records(data, cell_bits: int):
    """Index + cell entries + dense token records (the host-fed decode's
    scan, native/scanner.scan_stream_records).

    Returns (blocks, lengths, cells, recs); under ``DBG_NO_NATIVE=1`` the
    Python scan gives cells=None and recs=None, as the reference does.
    """
    if native.disabled():
        blocks, lengths = _scan_stream_py(data)
        return blocks, lengths, None, None
    return native_scanner.scan_stream_records(bytes(memoryview(data)),
                                              cell_bits=cell_bits)


def _scan_stream_py(data) -> tuple[list[BlockInfo], list]:
    _, blocks = inflate(data)
    lengths: list = []
    fixed = (C.fixed_litlen_lengths(), C.fixed_dist_lengths())
    for b in blocks:
        if b.btype == C.BTYPE_STORED:
            lengths.append(None)
        elif b.btype == C.BTYPE_FIXED:
            lengths.append(fixed)
        else:
            br = _BitReader(data, b.start_bit + 3)
            lengths.append(read_dynamic_lengths(br))
    return blocks, lengths
