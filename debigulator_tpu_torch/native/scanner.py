"""Python-facing wrappers over the native scanner, serial inflate, CRC-32
and Adler-32.

The port's copy of the scan, inflate and checksum parts of
debigulator_tpu/native/scanner.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.native import get_lib
from debigulator_tpu_torch.ops.inflate_ref import BlockInfo, InflateError


class _BlockRec(ctypes.Structure):
    _fields_ = [
        ("start_bit", ctypes.c_uint64),
        ("data_start_bit", ctypes.c_uint64),
        ("end_bit", ctypes.c_uint64),
        ("out_start", ctypes.c_uint64),
        ("out_size", ctypes.c_uint64),
        ("btype", ctypes.c_int32),
        ("bfinal", ctypes.c_int32),
    ]


def _scan_raw(data: bytes, cell_bits: int, produce_output: bool = False):
    """One native scan pass: block records, code lengths and, with
    cell_bits > 0, the exact per-cell entry states; with produce_output
    also the decoded bytes (the scanner is then a serial inflate).  Grows
    its buffers and retries when the native side reports them too small."""
    lib = get_lib()
    max_blocks = max(64, len(data) // 16 + 16)
    out_cap = max(1024, len(data) * 4) if produce_output else 0
    out_size = ctypes.c_uint64(0)
    n_cells = ctypes.c_int64(0)
    mct = ctypes.c_int32(0)
    while True:
        blocks = (_BlockRec * max_blocks)()
        lengths = np.zeros(max_blocks * 320, np.int32)
        # Every block is padded to a cell boundary, so the cell bound grows
        # with max_blocks (flush-heavy streams pack many sub-cell blocks).
        max_cells = ((len(data) * 8) // cell_bits + max_blocks + 16
                     if cell_bits else 0)
        cell_states = np.zeros(max_cells, np.int64)
        cell_pend = np.zeros(max_cells, np.int32)
        out_buf = np.zeros(out_cap, np.uint8) if produce_output else None
        nb = lib.dbg_scan(
            data, len(data),
            ctypes.cast(blocks, ctypes.c_void_p), max_blocks,
            lengths.ctypes.data_as(ctypes.c_void_p),
            out_buf.ctypes.data_as(ctypes.c_void_p) if produce_output else None,
            out_cap, ctypes.byref(out_size),
            cell_bits,
            cell_states.ctypes.data_as(ctypes.c_void_p) if cell_bits else None,
            cell_pend.ctypes.data_as(ctypes.c_void_p) if cell_bits else None,
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
    cells = None
    if cell_bits:
        cells = (cell_states[: n_cells.value], cell_pend[: n_cells.value],
                 int(mct.value))
    out = out_buf[: out_size.value] if produce_output else None
    return int(nb), blocks, lengths, cells, out


def _block_info(r: _BlockRec) -> BlockInfo:
    return BlockInfo(
        start_bit=int(r.start_bit),
        data_start_bit=int(r.data_start_bit),
        end_bit=int(r.end_bit),
        btype=int(r.btype),
        bfinal=bool(r.bfinal),
        out_start=int(r.out_start),
        out_size=int(r.out_size),
    )


def scan_stream(data: bytes, cell_bits: int = 0):
    """Block index + per-block code lengths via native code (no output).

    With cell_bits > 0 also returns the exact per-cell entries as a third
    element: (blocks, lengths, (cell_states, cell_pend, mct)).
    """
    nb, blocks, lengths, cells, _ = _scan_raw(data, cell_bits)
    infos, lens = [], []
    for i in range(nb):
        r = blocks[i]
        infos.append(_block_info(r))
        if r.btype == C.BTYPE_STORED:
            lens.append(None)
        else:
            ll = lengths[i * 320 : i * 320 + 288].copy()
            dd = lengths[i * 320 + 288 : i * 320 + 320].copy()
            lens.append((ll, dd))
    if cell_bits:
        return infos, lens, cells
    return infos, lens


def inflate_native(data: bytes):
    """Full serial native inflate -> (bytes, blocks)."""
    nb, blocks, _, _, out = _scan_raw(bytes(data), 0, produce_output=True)
    return out.tobytes(), [_block_info(blocks[i]) for i in range(nb)]


def crc32(data, crc: int = 0) -> int:
    lib = get_lib()
    data = bytes(memoryview(data))
    return int(lib.dbg_crc32(data, len(data), crc))


def adler32(data, adler: int = 1) -> int:
    lib = get_lib()
    data = bytes(memoryview(data))
    return int(lib.dbg_adler32(data, len(data), adler))
