"""Python-facing wrappers over the native scanner, record scan, group
packer, taint analysis, serial inflate, CRC-32 and Adler-32.

The port's copy of debigulator_tpu/native/scanner.py.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.native import get_lib
from debigulator_tpu_torch.ops.inflate_ref import BlockInfo, InflateError


#: One block record of the native scan (``BlockRec`` in
#: native/dbg_native.cpp): five uint64 and two int32, 48 bytes.
_BLOCK_REC = np.dtype([
    ("start_bit", np.uint64), ("data_start_bit", np.uint64),
    ("end_bit", np.uint64), ("out_start", np.uint64),
    ("out_size", np.uint64), ("btype", np.int32), ("bfinal", np.int32),
])


_SCRATCH = threading.local()


def _scratch(name: str, n: int, dtype) -> np.ndarray:
    """This thread's uninitialised buffer ``name`` of n items, kept from
    scan to scan and regrown when too small.  A fresh buffer sized by a
    long input costs page faults where the scan touches it on every call
    (on the H100's host, 0.45-0.63 ms a gzip member with 2.66 MB behind
    it); a reused one costs them once."""
    buf = getattr(_SCRATCH, name, None)
    if buf is None or len(buf) < n:
        buf = np.empty(n, dtype)
        setattr(_SCRATCH, name, buf)
    return buf[:n]


def _scan_raw(data, cell_bits: int, produce_output: bool = False):
    """One native scan pass over ``data`` where it lies (any contiguous
    buffer: bytes, bytearray, a memoryview slice, a NumPy array): block
    records, code lengths and, with cell_bits > 0, the exact per-cell
    entry states; with produce_output also the decoded bytes (the scanner
    is then a serial inflate).

    The scan stops at the stream's final block, so bytes after it cost
    nothing: the buffers are sized by ``len(data)`` but not initialised
    (the block, code-length and cell buffers are this thread's scratch),
    and the native side writes all that is read here (every field of the
    first ``nb`` block records and their 320 code lengths, the first
    ``n_cells`` cells, ``out_size`` bytes).  The results are copies of
    those prefixes, so the next scan may reuse the scratch.  Grows the
    buffers and retries when the native side reports them too small.

    Returns (blocks, lengths, cells, out): BlockInfo and code lengths per
    block as ``scan_stream`` gives them, cells as (states, pend, mct) or
    None, out as bytes or None."""
    lib = get_lib()
    buf = np.frombuffer(data, np.uint8)  # the caller's memory, no copy
    size = len(buf)
    max_blocks = max(64, size // 16 + 16)
    out_cap = max(1024, size * 4) if produce_output else 0
    out_size = ctypes.c_uint64(0)
    n_cells = ctypes.c_int64(0)
    mct = ctypes.c_int32(0)
    while True:
        blocks = _scratch("blocks", max_blocks, _BLOCK_REC)
        lengths = _scratch("lengths", max_blocks * 320, np.int32)
        # Every block is padded to a cell boundary, so the cell bound grows
        # with max_blocks (flush-heavy streams pack many sub-cell blocks).
        max_cells = ((size * 8) // cell_bits + max_blocks + 16
                     if cell_bits else 0)
        cell_states = _scratch("cell_states", max_cells, np.int64)
        cell_pend = _scratch("cell_pend", max_cells, np.int32)
        out_buf = np.empty(out_cap, np.uint8) if produce_output else None
        nb = lib.dbg_scan(
            buf.ctypes.data, size,
            blocks.ctypes.data, max_blocks,
            lengths.ctypes.data,
            out_buf.ctypes.data if produce_output else None,
            out_cap, ctypes.byref(out_size),
            cell_bits,
            cell_states.ctypes.data if cell_bits else None,
            cell_pend.ctypes.data if cell_bits else None,
            max_cells, ctypes.byref(n_cells), ctypes.byref(mct),
        )
        if nb == -3 and produce_output:
            out_cap *= 4
            continue
        if nb == -2 or (nb == -4 and cell_bits):
            max_blocks *= 4
            continue
        if nb < 0:
            raise InflateError(f"native scan failed (code {nb})")
        break
    infos, lens = _block_list(blocks[:nb], lengths)
    cells = None
    if cell_bits:
        n = n_cells.value
        cells = (cell_states[:n].copy(), cell_pend[:n].copy(),
                 int(mct.value))
    out = out_buf[: out_size.value].tobytes() if produce_output else None
    return infos, lens, cells, out


def scan_stream(data, cell_bits: int = 0):
    """Block index + per-block code lengths via native code (no output),
    over any contiguous buffer where it lies; bytes after the stream's
    final block are not read.

    With cell_bits > 0 also returns the exact per-cell entries as a third
    element: (blocks, lengths, (cell_states, cell_pend, mct)).
    """
    infos, lens, cells, _ = _scan_raw(data, cell_bits)
    if cell_bits:
        return infos, lens, cells
    return infos, lens


def _block_list(recs: np.ndarray, lengths: np.ndarray):
    """BlockInfo and (litlen, dist) code lengths, copied out, for each of
    the native block records ``recs`` (None for a stored block)."""
    infos, lens = [], []
    for i, (sb, dsb, eb, o0, osz, btype, bfinal) in enumerate(recs.tolist()):
        infos.append(BlockInfo(start_bit=sb, data_start_bit=dsb, end_bit=eb,
                               btype=btype, bfinal=bool(bfinal),
                               out_start=o0, out_size=osz))
        if btype == C.BTYPE_STORED:
            lens.append(None)
        else:
            lens.append((lengths[i * 320 : i * 320 + 288].copy(),
                         lengths[i * 320 + 288 : i * 320 + 320].copy()))
    return infos, lens


def scan_stream_records(data: bytes, cell_bits: int):
    """Block index + exact cell entries + dense token records (the scan
    of the host-fed decode).

    Returns (blocks, lengths, cells, recs); recs holds ``m_pos``/``m_meta``
    (match output offsets, len << 16 | dist), ``r_pos``/``r_cell``/
    ``r_j0len`` (literal runs: output offset, virtual cell, first tape slot
    << 8 | run length), ``lit_bytes`` (every literal in stream order),
    ``max_cell_tokens`` and ``out_size``.  Buffers start from a guess and
    grow: x4 blocks on -2/-4, x4 records and literals on -5.
    """
    lib = get_lib()
    max_blocks = max(64, len(data) // 16 + 16)
    # Worst case one token per compressed bit; start smaller and grow.
    max_m = max(1024, len(data) * 2)
    max_r = max(1024, len(data) * 2)
    max_l = max(1024, len(data) * 8)
    while True:
        blocks = np.zeros(max_blocks, _BLOCK_REC)
        lengths = np.zeros(max_blocks * 320, np.int32)
        max_cells = (len(data) * 8) // cell_bits + max_blocks + 16
        cell_states = np.zeros(max_cells, np.int64)
        cell_pend = np.zeros(max_cells, np.int32)
        m_pos = np.zeros(max_m, np.int32)
        m_meta = np.zeros(max_m, np.int32)
        r_pos = np.zeros(max_r, np.int32)
        r_cell = np.zeros(max_r, np.int32)
        r_j0len = np.zeros(max_r, np.int32)
        lit_bytes = np.zeros(max_l, np.uint8)
        n_cells = ctypes.c_int64(0)
        n_m = ctypes.c_int64(0)
        n_r = ctypes.c_int64(0)
        n_l = ctypes.c_int64(0)
        mct = ctypes.c_int32(0)
        out_size = ctypes.c_uint64(0)

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        nb = lib.dbg_scan2(
            data, len(data),
            ptr(blocks), max_blocks, ptr(lengths),
            cell_bits, ptr(cell_states), ptr(cell_pend),
            max_cells, ctypes.byref(n_cells),
            ptr(m_pos), ptr(m_meta), max_m, ctypes.byref(n_m),
            ptr(r_pos), ptr(r_cell), ptr(r_j0len), max_r, ctypes.byref(n_r),
            ctypes.byref(mct), ctypes.byref(out_size),
            ptr(lit_bytes), max_l, ctypes.byref(n_l),
        )
        if nb == -2 or nb == -4:
            max_blocks *= 4
            continue
        if nb == -5:
            max_m *= 4
            max_r *= 4
            max_l *= 4
            continue
        if nb < 0:
            raise InflateError(f"native scan2 failed (code {nb})")
        break
    infos, lens = _block_list(blocks[:nb], lengths)
    cells = (cell_states[: n_cells.value], cell_pend[: n_cells.value],
             int(mct.value))
    recs = {
        "m_pos": m_pos[: n_m.value].copy(),
        "m_meta": m_meta[: n_m.value].copy(),
        "r_pos": r_pos[: n_r.value].copy(),
        "r_cell": r_cell[: n_r.value].copy(),
        "r_j0len": r_j0len[: n_r.value].copy(),
        "lit_bytes": lit_bytes[: n_l.value].copy(),
        "max_cell_tokens": int(mct.value),
        "out_size": int(out_size.value),
    }
    return infos, lens, cells, recs


def pack_groups(m_pos: np.ndarray, m_meta: np.ndarray, seg_bytes: int,
                n_seg: int):
    """Pack matches into conflict-free groups of 8 (dbg_pack_groups in
    native/dbg_native.cpp): pieces of at most 128 bytes that never cross a
    128-byte output row, RLE matches as pattern-doubling pieces, no group
    across a ``seg_bytes`` boundary.

    Returns (g_pos, g_meta, seg_lo, seg_hi): piece output offsets, piece
    len << 16 | dist (padding: len 0 at the segment start) and each
    segment's slot range.  The slot buffer grows x4 until it fits."""
    lib = get_lib()
    n = len(m_pos)
    m_pos = np.ascontiguousarray(m_pos, np.int32)
    m_meta = np.ascontiguousarray(m_meta, np.int32)
    max_slots = 8 * (4 * max(n, 1) + 2 * n_seg + 64)
    while True:  # RLE-chain-heavy streams can need ~9 groups per match
        g_pos = np.zeros(max_slots, np.int32)
        g_meta = np.zeros(max_slots, np.int32)
        seg_lo = np.zeros(n_seg, np.int32)
        seg_hi = np.zeros(n_seg, np.int32)
        n_slots = lib.dbg_pack_groups(
            m_pos.ctypes.data_as(ctypes.c_void_p),
            m_meta.ctypes.data_as(ctypes.c_void_p),
            n, seg_bytes, n_seg,
            g_pos.ctypes.data_as(ctypes.c_void_p),
            g_meta.ctypes.data_as(ctypes.c_void_p),
            max_slots,
            seg_lo.ctypes.data_as(ctypes.c_void_p),
            seg_hi.ctypes.data_as(ctypes.c_void_p),
        )
        if n_slots >= 0:
            return g_pos[:n_slots], g_meta[:n_slots], seg_lo, seg_hi
        max_slots *= 4


def taint_matches(m_pos: np.ndarray, m_meta: np.ndarray, out_size: int,
                  shard_bytes: int, window: int = C.WINDOW_SIZE,
                  n_shards: int | None = None):
    """Exact taint analysis of the split-stream decode (dbg_taint in
    native/dbg_native.cpp).

    Returns (m_taint, tail_taint): per match, 1 when it writes a byte that
    derives, through copies, from its shard's incoming window; per shard,
    1 when such a byte lies in its outgoing ``window`` bytes.  m_pos/
    m_meta: matches in stream order (dst, len << 16 | dist), split at
    shard boundaries.

    n_shards sizes tail_taint for the caller's shard count even where
    rounding shard_bytes up leaves trailing shards with no output (the C
    loop clamps each shard's range to out_size, so those stay 0)."""
    lib = get_lib()
    n = len(m_pos)
    if n_shards is None:
        n_shards = max(1, -(-out_size // shard_bytes))
    m_pos = np.ascontiguousarray(m_pos, np.int32)
    m_meta = np.ascontiguousarray(m_meta, np.int32)
    taint_buf = np.zeros(max(out_size, 1), np.uint8)
    m_taint = np.zeros(max(n, 1), np.uint8)
    tail_taint = np.zeros(n_shards, np.uint8)
    lib.dbg_taint(
        m_pos.ctypes.data_as(ctypes.c_void_p),
        m_meta.ctypes.data_as(ctypes.c_void_p),
        n, out_size, shard_bytes, window,
        taint_buf.ctypes.data_as(ctypes.c_void_p),
        m_taint.ctypes.data_as(ctypes.c_void_p),
        tail_taint.ctypes.data_as(ctypes.c_void_p),
        n_shards,
    )
    return m_taint[:n], tail_taint


def inflate_native(data):
    """Full serial native inflate of any contiguous buffer -> (bytes,
    blocks)."""
    blocks, _, _, out = _scan_raw(data, 0, produce_output=True)
    return out, blocks


def crc32(data, crc: int = 0) -> int:
    lib = get_lib()
    data = bytes(memoryview(data))
    return int(lib.dbg_crc32(data, len(data), crc))


def adler32(data, adler: int = 1) -> int:
    lib = get_lib()
    data = bytes(memoryview(data))
    return int(lib.dbg_adler32(data, len(data), adler))
