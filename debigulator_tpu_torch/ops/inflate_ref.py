"""Serial host-side inflate (NumPy/CPython, bit-exact): the port's copy of
debigulator_tpu/ops/inflate_ref.py.

A clean-room RFC 1951 decompressor (all three BTYPEs, canonical Huffman,
32 KiB LZ77 window), deliberately simple and bounds-checked; speed does not
matter here (the device pipeline is the production path).  It is the
default inflate of the host codecs (``decode_png``, ``decode_zlib``,
``decode_gzip``) and, through ``scan_blocks`` and ops.scanner's Python
scan, the block index of the decode drivers when the native library is
switched off.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.ops.huffman import (
    DecodeTable,
    HuffmanError,
    build_decode_table,
)


class InflateError(ValueError):
    pass


class _BitReader:
    """LSB-first bit reader over a bytes-like object."""

    __slots__ = ("data", "pos", "bitbuf", "bitcnt", "nbytes")

    def __init__(self, data, start_bit: int = 0):
        self.data = memoryview(data)
        self.nbytes = len(self.data)
        self.pos = start_bit // 8
        self.bitbuf = 0
        self.bitcnt = 0
        rem = start_bit % 8
        if rem:
            self._fill(8)
            self.bitbuf >>= rem
            self.bitcnt -= rem

    def _fill(self, need: int):
        while self.bitcnt < need:
            if self.pos >= self.nbytes:
                raise InflateError("unexpected end of stream")
            self.bitbuf |= self.data[self.pos] << self.bitcnt
            self.pos += 1
            self.bitcnt += 8

    def bits(self, n: int) -> int:
        """Read n bits LSB-first (extra-bits / header fields)."""
        if n == 0:
            return 0
        self._fill(n)
        val = self.bitbuf & ((1 << n) - 1)
        self.bitbuf >>= n
        self.bitcnt -= n
        return val

    def align_byte(self):
        drop = self.bitcnt % 8
        self.bitbuf >>= drop
        self.bitcnt -= drop

    def bit_position(self) -> int:
        """Absolute bit offset of the next unread bit."""
        return self.pos * 8 - self.bitcnt

    def read_bytes(self, n: int) -> bytes:
        assert self.bitcnt % 8 == 0
        # Drain buffered whole bytes first.
        out = bytearray()
        while self.bitcnt and n:
            out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcnt -= 8
            n -= 1
        if n:
            if self.pos + n > self.nbytes:
                raise InflateError("unexpected end of stream (stored block)")
            out += self.data[self.pos : self.pos + n]
            self.pos += n
        return bytes(out)

    def decode_sym(self, t: DecodeTable) -> int:
        """Decode one canonical-Huffman code (MSB-first accumulation)."""
        code = 0
        length = 0
        count = t.count
        first = t.first_code
        while True:
            code = (code << 1) | self.bits(1)
            length += 1
            if length > t.max_len:
                raise InflateError("invalid Huffman code")
            off = code - first[length]
            if 0 <= off < count[length]:
                return int(t.syms[t.index_base[length] + off])


_FIXED_LITLEN = build_decode_table(C.fixed_litlen_lengths())
_FIXED_DIST = build_decode_table(C.fixed_dist_lengths())


def read_dynamic_lengths(br: _BitReader) -> tuple[np.ndarray, np.ndarray]:
    """Parse a dynamic block header, returning raw (litlen, dist) code
    lengths (RFC 1951 §3.2.7).  Advances the reader past the header."""
    hlit = br.bits(5) + 257
    hdist = br.bits(5) + 1
    hclen = br.bits(4) + 4
    if hlit > 286 or hdist > 30:
        raise InflateError("too many litlen/dist codes")
    cl_lengths = np.zeros(19, dtype=np.int32)
    for i in range(hclen):
        cl_lengths[C.CODE_LENGTH_ORDER[i]] = br.bits(3)
    try:
        cl_table = build_decode_table(cl_lengths)
    except HuffmanError as e:
        raise InflateError(f"bad code-length code: {e}")

    lengths = np.zeros(hlit + hdist, dtype=np.int32)
    i = 0
    while i < hlit + hdist:
        sym = br.decode_sym(cl_table)
        if sym < 16:
            lengths[i] = sym
            i += 1
        elif sym == 16:
            if i == 0:
                raise InflateError("repeat with no previous length")
            rep = 3 + br.bits(2)
            lengths[i : i + rep] = lengths[i - 1]
            i += rep
        elif sym == 17:
            i += 3 + br.bits(3)
        else:  # 18
            i += 11 + br.bits(7)
    if i != hlit + hdist:
        raise InflateError("code length overflow")
    if lengths[256] == 0:
        raise InflateError("no end-of-block code")
    return lengths[:hlit], lengths[hlit:]


def _read_dynamic_tables(br: _BitReader):
    """Parse HLIT/HDIST/HCLEN + RLE-coded code lengths (RFC 1951 §3.2.7)."""
    ll_lengths, d_lengths = read_dynamic_lengths(br)
    try:
        litlen = build_decode_table(ll_lengths)
        dist = build_decode_table(d_lengths)
    except HuffmanError as e:
        raise InflateError(f"bad dynamic table: {e}")
    return litlen, dist


@dataclasses.dataclass
class BlockInfo:
    """Metadata for one DEFLATE block (host pre-scan output)."""

    start_bit: int  # bit offset of BFINAL
    data_start_bit: int  # bit offset of first symbol (after tables)
    end_bit: int  # bit offset one past the block's last bit
    btype: int
    bfinal: bool
    out_start: int  # output byte offset where this block begins
    out_size: int  # decompressed size of this block


def inflate(data, max_output: int | None = None, start_bit: int = 0):
    """Decompress a raw DEFLATE stream.  Returns (output bytes, BlockInfo list).

    The block list doubles as the shard index for the parallel device path.
    """
    br = _BitReader(data, start_bit)
    out = bytearray()
    blocks: list[BlockInfo] = []
    window = C.WINDOW_SIZE
    while True:
        sb = br.bit_position()
        bfinal = br.bits(1)
        btype = br.bits(2)
        if btype == C.BTYPE_STORED:
            br.align_byte()
            length = br.bits(16)
            nlen = br.bits(16)
            if length ^ nlen != 0xFFFF:
                raise InflateError("stored block LEN/NLEN mismatch")
            db = br.bit_position()
            o0 = len(out)
            out += br.read_bytes(length)
            blocks.append(
                BlockInfo(sb, db, br.bit_position(), btype, bool(bfinal), o0, length)
            )
        elif btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC):
            if btype == C.BTYPE_FIXED:
                litlen, dist = _FIXED_LITLEN, _FIXED_DIST
            else:
                litlen, dist = _read_dynamic_tables(br)
            db = br.bit_position()
            o0 = len(out)
            while True:
                sym = br.decode_sym(litlen)
                if sym < 256:
                    out.append(sym)
                elif sym == 256:
                    break
                else:
                    if sym > 285:
                        raise InflateError(f"invalid length symbol {sym}")
                    li = sym - 257
                    length = int(C.LENGTH_BASE[li]) + br.bits(
                        int(C.LENGTH_EXTRA_BITS[li])
                    )
                    dsym = br.decode_sym(dist)
                    if dsym > 29:
                        raise InflateError(f"invalid distance symbol {dsym}")
                    d = int(C.DIST_BASE[dsym]) + br.bits(int(C.DIST_EXTRA_BITS[dsym]))
                    if d > len(out) or d > window:
                        raise InflateError("distance too far back")
                    # Overlap-safe byte copy (semantics of RFC 1951 §3.2.3).
                    for _ in range(length):
                        out.append(out[-d])
                if max_output is not None and len(out) > max_output:
                    raise InflateError("output exceeds caller capacity")
            blocks.append(
                BlockInfo(
                    sb, db, br.bit_position(), btype, bool(bfinal), o0, len(out) - o0
                )
            )
        else:
            raise InflateError("invalid block type 3")
        if bfinal:
            break
    return bytes(out), blocks


def scan_blocks(data, start_bit: int = 0) -> list[BlockInfo]:
    """Pre-scan: block boundaries + sizes (decodes, discards output)."""
    _, blocks = inflate(data, start_bit=start_bit)
    return blocks
