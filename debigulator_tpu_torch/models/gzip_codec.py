"""gzip (RFC 1952) container, host side: the port of
debigulator_tpu/models/gzip_codec.py.

Member header parsing (FEXTRA, FNAME, FCOMMENT and a verified FHCRC), the
exact multi-member index, the host decode with CRC-32 and ISIZE verified,
and ``encode_gzip`` over the host encoder.  The device decode is
models.pipeline.decode_gzip_device."""

from __future__ import annotations

import dataclasses
import struct

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.ops import checksum as ck
from debigulator_tpu_torch.ops.deflate_encode import deflate
from debigulator_tpu_torch.ops.inflate_ref import inflate as _inflate


class GzipError(ValueError):
    pass


@dataclasses.dataclass
class GzipMember:
    """One member of a (possibly concatenated) gzip file."""

    header_start: int
    deflate_start: int  # byte offset of the DEFLATE stream
    deflate_end: int  # byte offset one past it (= footer start)
    crc32: int  # footer CRC-32 of the uncompressed data
    isize: int  # footer size of the uncompressed data mod 2^32
    fname: bytes | None = None
    mtime: int = 0
    os: int = 255


def _parse_header(data: memoryview, at: int) -> tuple[int, dict]:
    """Parse the member header at ``at``; returns (payload offset, info)."""
    n = len(data)
    if at + 10 > n:
        raise GzipError("truncated gzip header")
    magic = bytes(data[at : at + 2])
    if magic != C.GZIP_MAGIC:
        raise GzipError(f"bad gzip magic {magic!r}")
    cm = data[at + 2]
    if cm != C.GZIP_CM_DEFLATE:
        raise GzipError(f"unsupported compression method {cm}")
    flg = data[at + 3]
    mtime = struct.unpack_from("<I", data, at + 4)[0]
    os_ = data[at + 9]
    p = at + 10
    if flg & C.GZIP_FEXTRA:
        if p + 2 > n:
            raise GzipError("truncated FEXTRA")
        xlen = struct.unpack_from("<H", data, p)[0]
        p += 2 + xlen
    fname = None
    if flg & C.GZIP_FNAME:
        end = p
        while end < n and data[end] != 0:
            end += 1
        if end >= n:
            raise GzipError("unterminated FNAME")
        fname = bytes(data[p:end])
        p = end + 1
    if flg & C.GZIP_FCOMMENT:
        while p < n and data[p] != 0:
            p += 1
        if p >= n:
            raise GzipError("unterminated FCOMMENT")
        p += 1
    if flg & C.GZIP_FHCRC:
        if p + 2 > n:
            raise GzipError("truncated FHCRC")
        hcrc = struct.unpack_from("<H", data, p)[0]
        computed = ck.crc32(bytes(data[at:p])) & 0xFFFF
        if hcrc != computed:
            raise GzipError("header CRC16 mismatch")
        p += 2
    if p > n - 8:
        raise GzipError("gzip member has no room for payload+footer")
    return p, {"mtime": mtime, "os": os_, "fname": fname}


def parse_first_member(data) -> GzipMember:
    """Structurally index the FIRST member, assuming its footer is the
    file tail (valid for single-member files only).  Concatenated files
    need `parse_gzip_members` / `index_members_exact`."""
    data = memoryview(data)
    n = len(data)
    p, hdr = _parse_header(data, 0)
    end = n - 8
    crc, isize = struct.unpack_from("<II", data, end)
    return GzipMember(
        header_start=0,
        deflate_start=p,
        deflate_end=end,
        crc32=crc,
        isize=isize,
        fname=hdr["fname"],
        mtime=hdr["mtime"],
        os=hdr["os"],
    )


def parse_gzip_members(data) -> list[GzipMember]:
    """Walk a gzip file and index EVERY member exactly.

    Finding member k+1 requires decoding member k's DEFLATE stream (the
    bit stream determines its own end), so this delegates to
    `index_members_exact`.  Callers that only need the cheap
    single-member view use `parse_first_member`.
    """
    return index_members_exact(data)


def index_members_exact(data, inflate_fn=None) -> list[GzipMember]:
    """Exact multi-member index: decode each member to find its end.

    inflate_fn(data, start_bit=0) -> (out_bytes, blocks) — defaults to the
    serial Python inflate.  Returns members with exact deflate_end/footer fields.
    """
    inflate_fn = inflate_fn or _inflate
    data = memoryview(data)
    n = len(data)
    members = []
    at = 0
    while at < n:
        p, hdr = _parse_header(data, at)
        out, blocks = inflate_fn(bytes(data[p:]))
        end_bit = blocks[-1].end_bit
        end = p + (end_bit + 7) // 8
        if end + 8 > n:
            raise GzipError("truncated gzip footer")
        crc, isize = struct.unpack_from("<II", data, end)
        members.append(
            GzipMember(at, p, end, crc, isize, hdr["fname"], hdr["mtime"], hdr["os"])
        )
        at = end + 8
    return members


def decode_gzip(data, verify: bool = True, inflate_fn=None) -> bytes:
    """Decode a (possibly multi-member) gzip file to bytes on the host.

    inflate_fn defaults to the serial Python inflate; the device pipeline
    (models.pipeline.decode_gzip_device) walks the members the same way
    and decodes on the card.
    """
    inflate_fn = inflate_fn or _inflate
    data = memoryview(data)
    n = len(data)
    if n == 0:
        raise GzipError("empty input is not a gzip stream")
    out_parts = []
    at = 0
    while at < n:
        p, hdr = _parse_header(data, at)
        out, blocks = inflate_fn(bytes(data[p:]))
        end_bit = blocks[-1].end_bit
        end = p + (end_bit + 7) // 8
        if end + 8 > n:
            raise GzipError("truncated gzip footer")
        crc, isize = struct.unpack_from("<II", data, end)
        if verify:
            if len(out) & 0xFFFFFFFF != isize:
                raise GzipError(f"ISIZE mismatch: {len(out)} vs {isize}")
            if ck.crc32(out) != crc:
                raise GzipError("CRC-32 mismatch")
        out_parts.append(out)
        at = end + 8
    return b"".join(out_parts)


def encode_gzip(data: bytes, deflate_fn=None, fname: bytes | None = None) -> bytes:
    """One gzip member of ``data`` (FNAME set when ``fname`` is given).

    deflate_fn(data) -> raw DEFLATE bytes; the default is the host encoder
    ``ops.deflate_encode.deflate``, as in the reference.
    """
    flg = C.GZIP_FNAME if fname else 0
    header = struct.pack("<2sBBIBB", C.GZIP_MAGIC, C.GZIP_CM_DEFLATE, flg, 0, 0, 255)
    if fname:
        header += fname + b"\x00"
    payload = (deflate_fn or deflate)(data)
    footer = struct.pack("<II", ck.crc32(data), len(data) & 0xFFFFFFFF)
    return header + payload + footer
