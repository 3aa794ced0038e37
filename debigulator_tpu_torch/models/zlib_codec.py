"""zlib (RFC 1950) container: header/footer parse + verify, encode (the
port of debigulator_tpu/models/zlib_codec.py).

Parity target: the reference's zlib-header checks on the first PNG IDAT
chunk (reference decode_png.c:1163-1265: CM/CINFO, FCHECK %31, FDICT
rejected) — plus Adler-32 verification, which the reference never does
(SURVEY §2.10.5).
"""

from __future__ import annotations

import dataclasses
import struct

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.ops import checksum as ck
from debigulator_tpu_torch.ops.deflate_encode_device import deflate_fixed_device
from debigulator_tpu_torch.ops.inflate_ref import inflate as _inflate


class ZlibError(ValueError):
    pass


@dataclasses.dataclass
class ZlibHeader:
    cm: int
    cinfo: int
    fdict: bool
    flevel: int


def parse_zlib_header(data) -> ZlibHeader:
    data = memoryview(data)
    if len(data) < 2:
        raise ZlibError("truncated zlib header")
    cmf, flg = data[0], data[1]
    if (cmf * 256 + flg) % 31 != 0:
        raise ZlibError("zlib FCHECK failed")
    cm = cmf & 0x0F
    cinfo = cmf >> 4
    if cm != C.ZLIB_CM_DEFLATE:
        raise ZlibError(f"unsupported zlib CM {cm}")
    if cinfo > 7:
        raise ZlibError(f"invalid CINFO {cinfo}")
    fdict = bool(flg & 0x20)
    if fdict:
        raise ZlibError("FDICT preset dictionaries unsupported")
    return ZlibHeader(cm=cm, cinfo=cinfo, fdict=fdict, flevel=flg >> 6)


def decode_zlib(data, verify: bool = True, inflate_fn=None) -> bytes:
    """Decode a full zlib stream (2-byte header + DEFLATE + 4-byte Adler).

    inflate_fn(bytes) -> (out_bytes, blocks); the default is the serial
    Python inflate of ops.inflate_ref."""
    inflate_fn = inflate_fn or _inflate
    parse_zlib_header(data)
    out, blocks = inflate_fn(bytes(memoryview(data)[2:]))
    if verify:
        end = 2 + (blocks[-1].end_bit + 7) // 8
        if end + 4 > len(data):
            raise ZlibError("truncated Adler-32 footer")
        (expected,) = struct.unpack_from(">I", data, end)
        if ck.adler32(out) != expected:
            raise ZlibError("Adler-32 mismatch")
    return out


def zlib_wrap(payload: bytes, data: bytes, level_hint: int = 2) -> bytes:
    """Wrap a raw DEFLATE payload: CMF/FLG header + big-endian Adler-32."""
    cmf = (7 << 4) | C.ZLIB_CM_DEFLATE  # 32 KiB window
    flg = level_hint << 6
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    return bytes([cmf, flg]) + payload + struct.pack(">I", ck.adler32(data))


def encode_zlib(data: bytes, deflate_fn=None, device="cuda") -> bytes:
    """zlib stream of ``data``.  deflate_fn(bytes) -> raw DEFLATE bytes; the
    default is the device encoder (one fixed-Huffman block, LZ77 selection
    on ``device``)."""
    if deflate_fn is None:
        def deflate_fn(d):
            return deflate_fixed_device(d, device=device)

    return zlib_wrap(deflate_fn(data), data)
