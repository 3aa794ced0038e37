"""PNG inputs for the PyTorch port's tests, made with zlib and numpy: every
color type the decoders take, a random filter type per row, split IDAT
chunks, and the corruptions the error tests need."""

import struct
import zlib

import numpy as np

from debigulator_tpu_torch.models import png_codec
from debigulator_tpu_torch.ops import unfilter as uf

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def make_png(pix, color_type, palette=None, trns=None, level=6, seed=0,
             depth=8, interlace=0, idat_split=1):
    """A PNG of (h, w, channels) uint8 samples: random filter type per
    row, zlib at ``level``, IDAT split into ``idat_split`` chunks."""
    h, w, ch = pix.shape
    rng = np.random.RandomState(seed)
    rows = pix.reshape(h, w * ch)
    prev = np.zeros(w * ch, np.uint8)
    filtered = bytearray()
    for y in range(h):
        f = int(rng.randint(0, 5))
        filtered.append(f)
        filtered += uf.filter_row(rows[y], prev, ch, f).tobytes()
        prev = rows[y]
    idat = zlib.compress(bytes(filtered), level)
    out = png_codec.C.PNG_SIGNATURE + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                             interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns.tobytes())
    out += _chunk(b"tEXt", b"Comment\x00made for a test")
    step = -(-len(idat) // idat_split)
    for at in range(0, len(idat), step):
        out += _chunk(b"IDAT", idat[at : at + step])
    return out + _chunk(b"IEND", b"")


def make_case(color_type, h, w, seed):
    """(png bytes, expected (h, w, 4) RGBA) with low-entropy rows so the
    stream holds real matches."""
    rng = np.random.RandomState(seed)
    ch = CHANNELS[color_type]
    palette = trns = None
    if color_type == 3:
        palette = rng.randint(0, 256, (40, 3)).astype(np.uint8)
        trns = rng.randint(0, 256, 17).astype(np.uint8)
        pix = rng.randint(0, 40, (h, w, 1)).astype(np.uint8)
    else:
        pix = rng.randint(0, 256, (h, w, ch)).astype(np.uint8)
    pix[::2] = pix[0]
    png = make_png(pix, color_type, palette, trns, level=6 + seed % 4,
                   seed=seed, idat_split=1 + seed % 3)
    rgba = np.empty((h, w, 4), np.uint8)
    if color_type == 6:
        rgba[:] = pix
    elif color_type == 2:
        rgba[..., :3], rgba[..., 3] = pix, 255
    elif color_type == 0:
        rgba[..., :3], rgba[..., 3] = pix, 255
    elif color_type == 4:
        rgba[..., :3], rgba[..., 3] = pix[..., :1], pix[..., 1]
    else:
        alpha = np.full(40, 255, np.uint8)
        alpha[:17] = trns
        rgba[..., :3], rgba[..., 3] = palette[pix[..., 0]], alpha[pix[..., 0]]
    return png, rgba


#: (color type, height, width) of the single-image cases.
CASES = [(6, 21, 13), (2, 16, 9), (3, 11, 30), (4, 12, 7), (0, 9, 17)]


def corpus():
    """Two shape buckets with two images in one, and three singles."""
    specs = [(6, 21, 13, 1), (2, 16, 9, 2), (6, 21, 13, 3), (3, 11, 30, 4),
             (4, 12, 7, 5), (0, 9, 17, 6), (2, 16, 9, 7)]
    cases = [make_case(ct, h, w, seed) for ct, h, w, seed in specs]
    return [c[0] for c in cases], [c[1] for c in cases]


def corrupt(kind):
    pix = np.random.RandomState(3).randint(0, 256, (12, 10, 4)).astype(np.uint8)
    pix[::2] = pix[0]
    if kind == "interlace":
        return make_png(pix, 6, interlace=1)
    if kind == "depth16":
        return make_png(pix, 6, depth=16)
    if kind == "size":  # IHDR claims one row more than the stream holds
        png = bytearray(make_png(pix, 6))
        png[16 + 4 : 16 + 8] = struct.pack(">I", 13)
        png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])))
        return bytes(png)
    png = bytearray(make_png(pix, 6))
    at = png.index(b"IDAT")
    (length,) = struct.unpack_from(">I", png, at - 4)
    if kind == "crc":
        png[at + 4 + length] ^= 0xFF
    elif kind == "adler":  # flip the Adler word, then repair the chunk CRC
        png[at + 4 + length - 1] ^= 0xFF
        png[at + 4 + length : at + 8 + length] = struct.pack(
            ">I", zlib.crc32(bytes(png[at : at + 4 + length])))
    return bytes(png)
