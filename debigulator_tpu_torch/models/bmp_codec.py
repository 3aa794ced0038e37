"""BMP codec: 32-bpp uncompressed decode + encode (the port of
debigulator_tpu/models/bmp_codec.py).

Parity target: reference decode_bmp.{h,c} — 'BM' file header + 40/108-byte
DIB header (decode_bmp.c:15-49, :159-178), 32bpp uncompressed only
(:214-222), bottom-up vs top-down via height sign (:180-187), BGRA→RGBA
swizzle with row flip (:266-301), and encode_BMP's 54-byte header + BGRA
top-down output (:307-372).  The swizzle/flip is a pure permutation —
expressible as one gather, so both a NumPy and a tensor path are provided.
"""

from __future__ import annotations

import struct

import numpy as np
import torch


class BmpError(ValueError):
    pass


def get_bmp_width_height(data) -> tuple[int, int]:
    data = memoryview(data)
    if len(data) < 26 or bytes(data[:2]) != b"BM":
        raise BmpError("bad BMP magic")
    w, h = struct.unpack_from("<ii", data, 18)
    return w, abs(h)


def decode_bmp(data) -> np.ndarray:
    """Decode 32-bpp BMP → (h, w, 4) RGBA uint8."""
    data = memoryview(data)
    if len(data) < 54 or bytes(data[:2]) != b"BM":
        raise BmpError("bad BMP magic")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    dib_size = struct.unpack_from("<I", data, 14)[0]
    if dib_size not in (40, 108, 124):
        raise BmpError(f"unsupported DIB header size {dib_size}")
    w, h = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    compression = struct.unpack_from("<I", data, 30)[0]
    if planes != 1:
        raise BmpError(f"planes must be 1, got {planes}")
    if bpp != 32:
        raise BmpError(f"only 32-bpp supported, got {bpp}")
    if compression not in (0, 3):  # BI_RGB / BI_BITFIELDS-as-BGRA
        raise BmpError(f"unsupported compression {compression}")
    top_down = h < 0
    h = abs(h)
    need = pixel_offset + w * h * 4
    if len(data) < need:
        raise BmpError("truncated BMP pixel data")
    px = np.frombuffer(data, np.uint8, count=w * h * 4, offset=pixel_offset)
    img = px.reshape(h, w, 4)
    if not top_down:
        img = img[::-1]
    # BGRA → RGBA
    return img[..., [2, 1, 0, 3]].copy()


def encode_bmp(rgba: np.ndarray) -> bytes:
    """Encode (h, w, 4) RGBA → 32-bpp BMP, top-down (negative height),
    matching the reference encoder's layout (decode_bmp.c:307-372)."""
    rgba = np.asarray(rgba, dtype=np.uint8)
    h, w, ch = rgba.shape
    if ch != 4:
        raise BmpError("encode_bmp expects RGBA")
    bgra = rgba[..., [2, 1, 0, 3]]
    pixels = bgra.tobytes()
    file_header = struct.pack("<2sIHHI", b"BM", 54 + len(pixels), 0, 0, 54)
    dib = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 32, 0, len(pixels), 2835, 2835, 0, 0)
    return file_header + dib + pixels


def decode_bmp_tensor(pixel_data: torch.Tensor, height: int, width: int,
                      top_down: bool) -> torch.Tensor:
    """Swizzle + flip on the tensor's device: (h*w*4,) uint8 BGRA ->
    (h, w, 4) RGBA (the counterpart of the reference's decode_bmp_jnp)."""
    img = pixel_data.reshape(height, width, 4)
    if not top_down:
        img = img.flip(0)
    return img[..., torch.tensor([2, 1, 0, 3], device=img.device)]
