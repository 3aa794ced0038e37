"""gzip (RFC 1952) member header parsing: the port's copy of ``GzipError``
and ``_parse_header`` from debigulator_tpu/models/gzip_codec.py (FEXTRA,
FNAME, FCOMMENT and a verified FHCRC)."""

from __future__ import annotations

import struct

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.ops import checksum as ck


class GzipError(ValueError):
    pass


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
