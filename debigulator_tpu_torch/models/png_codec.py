"""PNG codec: chunk walk, CRC verification, decode-to-RGBA, encode (the
port of debigulator_tpu/models/png_codec.py).

Parity target: reference decode_png.{h,c} (signature check :730-753, chunk
walk :755-1355, IHDR validation :951-1137, PLTE palette :900-950, zlib
header on first IDAT :1163-1265, multi-IDAT aggregation :1285-1291,
unfilter :1422-1507, RGB→RGBA :1512-1535, palette→RGBA :1538-1564) and the
encoder stb_write.h:1128-1212.

Deliberate upgrades over the reference (SURVEY §2.10): Adler-32 verified,
interlace rejected explicitly, gray / gray+alpha color types supported in
addition to 2/3/6, IHDR must be the first chunk, all sizes bounded.

This module is the host orchestration layer; the hot compute (inflate,
unfilter, filter search, deflate) is pluggable.  ``decode_png`` defaults
to the serial Python inflate and the NumPy unfilter; ``encode_png``
defaults to the device filter search and the host encoder
(``ops.deflate_encode.deflate``), as the reference does.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.models.zlib_codec import (
    ZlibError,
    encode_zlib,
    parse_zlib_header,
)
from debigulator_tpu_torch.ops import checksum as ck
from debigulator_tpu_torch.ops import unfilter as uf
from debigulator_tpu_torch.ops.inflate_ref import inflate as _inflate
from debigulator_tpu_torch.utils.profiling import named_scope


class PngError(ValueError):
    pass


@dataclasses.dataclass
class PngInfo:
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int
    channels: int

    @property
    def bpp(self) -> int:
        return self.channels * self.bit_depth // 8

    @property
    def stride(self) -> int:
        return self.width * self.bpp


@dataclasses.dataclass
class PngChunks:
    info: PngInfo
    idat: bytes  # concatenated IDAT payloads (one zlib stream)
    palette: np.ndarray | None  # (n,3) uint8
    trns: np.ndarray | None  # (n,) uint8 palette alpha


def get_png_width_height(data) -> tuple[int, int]:
    """Like reference decode_png_get_width_height (decode_png.c:620-671) but
    actually validates that IHDR is the first chunk (SURVEY §2.10.5)."""
    info = _parse_ihdr(memoryview(data))
    return info.width, info.height


def _parse_ihdr(data: memoryview) -> PngInfo:
    if len(data) < 8 + 25 or bytes(data[:8]) != C.PNG_SIGNATURE:
        raise PngError("bad PNG signature")
    length, ctype = struct.unpack_from(">I4s", data, 8)
    if ctype != b"IHDR" or length != 13:
        raise PngError("IHDR must be the first chunk")
    w, h, depth, color, comp, filt, interlace = struct.unpack_from(
        ">IIBBBBB", data, 16
    )
    if w == 0 or h == 0 or w > 1 << 24 or h > 1 << 24:
        raise PngError(f"bad dimensions {w}x{h}")
    if depth != 8:
        raise PngError(f"unsupported bit depth {depth} (only 8 supported)")
    if color not in C.PNG_CHANNELS:
        raise PngError(f"unsupported color type {color}")
    if comp != 0:
        raise PngError(f"bad compression method {comp}")
    if filt != 0:
        raise PngError(f"bad filter method {filt}")
    if interlace != 0:
        raise PngError("Adam7 interlace unsupported")
    return PngInfo(w, h, depth, color, interlace, C.PNG_CHANNELS[color])


def parse_chunks(data, verify_crc: bool = True) -> PngChunks:
    """Walk chunks until IEND; aggregate IDAT; verify per-chunk CRC-32."""
    data = memoryview(data)
    info = _parse_ihdr(data)
    at = 8
    idat_parts: list[bytes] = []
    idat_done = False
    palette = None
    trns = None
    n = len(data)
    seen_iend = False
    while at + 8 <= n:
        length, ctype = struct.unpack_from(">I4s", data, at)
        if at + 12 + length > n:
            raise PngError(f"truncated chunk {ctype!r}")
        payload = data[at + 8 : at + 8 + length]
        if verify_crc:
            with named_scope("dbg.check"):
                (crc,) = struct.unpack_from(">I", data, at + 8 + length)
                computed = ck.crc32(bytes(data[at + 4 : at + 8 + length]))
                if crc != computed:
                    raise PngError(f"CRC mismatch in {ctype!r} chunk")
        if ctype == b"IHDR":
            pass  # already parsed (re-validated position above)
        elif ctype == b"PLTE":
            if length % 3 or length > 256 * 3:
                raise PngError("bad PLTE size")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3).copy()
        elif ctype == b"tRNS":
            if info.color_type == C.PNG_COLOR_PALETTE:
                trns = np.frombuffer(payload, np.uint8).copy()
        elif ctype == b"IDAT":
            if idat_done:
                raise PngError("non-consecutive IDAT chunks")
            idat_parts.append(bytes(payload))
        elif ctype == b"IEND":
            seen_iend = True
            break
        else:
            if idat_parts:
                idat_done = True
            # Ancillary chunks (lowercase first letter) are skippable;
            # unknown critical chunks are an error (decode_png.c:1303-1319).
            if not (ctype[0] & 0x20):
                raise PngError(f"unknown critical chunk {ctype!r}")
        if idat_parts and ctype != b"IDAT":
            idat_done = True
        at += 12 + length
    if not seen_iend:
        raise PngError("missing IEND")
    if not idat_parts:
        raise PngError("no IDAT data")
    if info.color_type == C.PNG_COLOR_PALETTE and palette is None:
        raise PngError("palette image without PLTE")
    return PngChunks(info=info, idat=b"".join(idat_parts), palette=palette, trns=trns)


def expand_to_rgba(recon: np.ndarray, info: PngInfo, palette, trns) -> np.ndarray:
    """(h, stride) reconstructed bytes → (h, w, 4) RGBA (pure gather/swizzle)."""
    h, w = info.height, info.width
    ct = info.color_type
    if ct == C.PNG_COLOR_RGBA:
        return recon.reshape(h, w, 4)
    rgba = np.empty((h, w, 4), dtype=np.uint8)
    if ct == C.PNG_COLOR_RGB:
        rgba[..., :3] = recon.reshape(h, w, 3)
        rgba[..., 3] = 255
    elif ct == C.PNG_COLOR_PALETTE:
        idx = recon.reshape(h, w)
        if int(idx.max(initial=0)) >= len(palette):
            raise PngError("palette index out of range")
        rgba[..., :3] = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns)] = trns
            rgba[..., 3] = alpha[idx]
        else:
            rgba[..., 3] = 255
    elif ct == C.PNG_COLOR_GRAY:
        g = recon.reshape(h, w)
        rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = g
        rgba[..., 3] = 255
    elif ct == C.PNG_COLOR_GRAY_ALPHA:
        ga = recon.reshape(h, w, 2)
        rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = ga[..., 0]
        rgba[..., 3] = ga[..., 1]
    else:
        raise PngError(f"unsupported color type {ct}")
    return rgba


def decode_png(
    data,
    verify_crc: bool = True,
    verify_adler: bool = True,
    inflate_fn=None,
    unfilter_fn=None,
) -> np.ndarray:
    """Decode a PNG to (h, w, 4) RGBA uint8 (host path; device path pluggable).

    inflate_fn(bytes) -> (out_bytes, blocks), default the serial Python
    inflate of ops.inflate_ref (pass native.scanner.inflate_native for the
    fast host form); unfilter_fn(filtered, h, w, bpp) -> (h, stride) uint8,
    default the NumPy oracle.
    """
    chunks = parse_chunks(data, verify_crc=verify_crc)
    info = chunks.info
    parse_zlib_header(chunks.idat)

    inflate_fn = inflate_fn or _inflate
    raw, blocks = inflate_fn(chunks.idat[2:])
    expected_size = info.height * (1 + info.stride)
    if len(raw) != expected_size:
        raise PngError(f"decompressed size {len(raw)} != expected {expected_size}")
    if verify_adler:
        end = 2 + (blocks[-1].end_bit + 7) // 8
        if end + 4 > len(chunks.idat):
            raise ZlibError("truncated Adler-32 footer")
        (expected,) = struct.unpack_from(">I", chunks.idat, end)
        if ck.adler32(raw) != expected:
            raise ZlibError("IDAT Adler-32 mismatch")

    unfilter_fn = unfilter_fn or uf.unfilter_image
    recon = unfilter_fn(
        np.frombuffer(raw, np.uint8), info.height, info.width, info.bpp
    )
    return expand_to_rgba(np.asarray(recon), info, chunks.palette, chunks.trns)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    crc = ck.crc32(ctype + payload)
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", crc)


def encode_png(rgba: np.ndarray, deflate_fn=None, filter_fn=None,
               device="cuda") -> bytes:
    """Encode (h, w, 4|3|2|1) uint8 to PNG (color type 6/2/4/0, bit depth 8):
    per-row best-of-5 filter search -> one zlib stream -> single IDAT.

    The default filter search runs on ``device`` (tensor ops; the same
    bytes as the reference's host search), and the default encoder is the
    host ``ops.deflate_encode.deflate``, as in the reference.  The device
    encoder, with the scanline stride as a candidate distance, is
    ``deflate_fn=lambda d: deflate_fixed_device(d, stride=1 + w * ch,
    device=dev)``.  filter_fn(raw (h, w*ch), h, w, ch) -> filtered bytes;
    deflate_fn(bytes) -> raw DEFLATE bytes.
    """
    rgba = np.asarray(rgba, dtype=np.uint8)
    if rgba.ndim == 2:
        rgba = rgba[..., None]
    h, w, ch = rgba.shape
    color_type = {1: C.PNG_COLOR_GRAY, 2: C.PNG_COLOR_GRAY_ALPHA,
                  3: C.PNG_COLOR_RGB, 4: C.PNG_COLOR_RGBA}[ch]
    raw = np.ascontiguousarray(rgba).reshape(h, w * ch)
    if filter_fn is None:
        dev = resolve_device(device)
        filtered = uf.filter_image_best_device(
            torch.from_numpy(raw).to(dev), h, w, ch).cpu().numpy()
    else:
        filtered = filter_fn(raw, h, w, ch)
    idat = encode_zlib(bytes(filtered), deflate_fn=deflate_fn)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        C.PNG_SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", idat)
        + _chunk(b"IEND", b"")
    )
