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
"""

from __future__ import annotations

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
    return native_scanner.scan_stream(bytes(memoryview(data)))


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
        return blocks, lengths, None
    return native_scanner.scan_stream(bytes(memoryview(data)),
                                      cell_bits=cell_bits)


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
