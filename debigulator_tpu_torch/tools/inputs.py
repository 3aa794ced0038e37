"""The synthetic inputs that chip_smoke.py and the port's tools decode and
encode, made from numpy seeds with zlib and struct (no file is read).

* ``obj_text``: 561,872 bytes of Wavefront-OBJ-like text (numpy seed 0);
  ``make_streams`` compresses K rotations of it at levels 6-9, the shape
  of bench.py's gzip workload;
* ``make_corpus``: 16 PNGs (RGBA, RGB, gray+alpha, palette with tRNS,
  gray, one image cycling through all five filters; 63,283,240 RGBA
  bytes) with their pixels and filtered scanlines;
* ``big_image_png``: one noisy 4096 x 4096 RGBA PNG (numpy seed 1);
* ``k4_png``: tools/check_4k_unfilter.py's nearly incompressible 4096 x
  4096 RGBA PNG (numpy ``default_rng(5)``, filters cycling 0-4, 1 MiB
  IDAT chunks).

The pixels and scanlines depend on numpy alone; the PNG and DEFLATE bytes
on the machine's zlib as well.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

N_STREAMS = 29
BASE_BYTES = 561_872


def obj_text(seed: int = 0, size: int = BASE_BYTES) -> bytes:
    """Wavefront-OBJ-like text (v / vt / vn / f lines on a coarse grid, so
    lines repeat the way exported meshes do), made from a numpy seed."""
    rng = np.random.default_rng(seed)
    parts = ["# Blender v2.79 (sub 0) OBJ File: ''\n# www.blender.org\n"
             "mtllib sample.mtl\n"]
    total, n, obj = len(parts[0]), 0, 0
    while total < size:
        obj += 1
        nv = int(rng.integers(40, 120))
        v = rng.integers(-24, 25, (nv, 3)) / 8.0
        vt = rng.integers(0, 17, (nv, 2)) / 16.0
        vn = rng.integers(-1, 2, (nv, 3)).astype(float)
        lines = [f"o Mesh.{obj:03d}"]
        lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
        lines += [f"vt {u:.6f} {w:.6f}" for u, w in vt]
        lines += [f"vn {x:.4f} {y:.4f} {z:.4f}" for x, y, z in vn]
        lines += ["usemtl Material.001", "s off"]
        for _ in range(nv):
            idx = n + rng.integers(1, nv + 1, 3)
            lines.append("f " + " ".join(f"{a}/{a}/{a}" for a in idx))
        n += nv
        chunk = "\n".join(lines) + "\n"
        parts.append(chunk)
        total += len(chunk)
    return "".join(parts).encode()[:size]


def make_streams(base: bytes, k: int) -> list[bytes]:
    """bench.py's _make_streams: rotate the content, compress at 6..9."""
    streams = []
    for i in range(k):
        rot = (i * 40961) % len(base)
        c = zlib.compressobj(6 + (i % 4), zlib.DEFLATED, -15)
        streams.append(c.compress(base[rot:] + base[:rot]) + c.flush())
    return streams


PNG_SIGNATURE = bytes([137, 80, 78, 71, 13, 10, 26, 10])
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: (name, color type, height, width) of the corpus images; 713 x 1040 RGB
#: is the shape of the reference corpus's most common images.
CORPUS_SPECS = ([("rgba", 6, 1024, 1024)] * 6 + [("rgb", 2, 713, 1040)] * 5
                + [("graya", 4, 351, 387)] * 2 + [("pal", 3, 480, 640),
                                                 ("gray", 0, 2048, 2048),
                                                 ("cycle", 6, 1024, 1024)])
#: Side of the one large RGBA image decoded on its own.
BIG_SIDE = 4096


def smooth_pixels(rng, h: int, w: int, ch: int, noisy: bool = False) -> np.ndarray:
    """(h, w, ch) uint8: stepped gradients, a band of low noise (every row
    when `noisy`, which makes the zlib stream several times longer) and flat
    rectangles, so the streams hold real matches of many lengths."""
    y, x = np.mgrid[0:h, 0:w]
    planes = []
    for _ in range(ch):
        kx, ky = (int(v) for v in rng.integers(1, 4, 2))
        planes.append(((x * kx + y * ky) // int(rng.integers(3, 9))) & 0xFF)
    img = np.stack(planes, -1).astype(np.uint8)
    band = slice(0, h) if noisy else slice(h // 4, h // 2)
    img[band] += rng.integers(0, 3, img[band].shape, dtype=np.uint8)
    img[h // 2 : h // 2 + h // 4, w // 3 : 2 * w // 3] = \
        rng.integers(0, 256, ch, dtype=np.uint8)
    img[-(h // 8 + 1) :, : w // 2] = rng.integers(0, 256, ch, dtype=np.uint8)
    return img


def filter_scanlines(pix: np.ndarray, ftypes=None) -> bytes:
    """PNG filtering of (h, w, ch) samples: per row the filter type given,
    or the one with the least sum of absolute signed residuals."""
    h, w, ch = pix.shape
    stride = w * ch
    raw = pix.reshape(h, stride).astype(np.int16)
    left = np.zeros_like(raw)
    left[:, ch:] = raw[:, :-ch]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, ch:] = raw[:-1, :-ch]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    del p, pa, pb, pc, upleft
    out = np.empty((h, 1 + stride), np.uint8)
    best = np.full(h, np.iinfo(np.int64).max)
    for f, pred in enumerate((0, left, up, (left + up) >> 1, paeth)):
        cand = ((raw - pred) & 0xFF).astype(np.uint8)
        if ftypes is None:
            score = np.abs(cand.view(np.int8).astype(np.int16)).sum(
                1, dtype=np.int64)
            rows = score < best
            best = np.where(rows, score, best)
        else:
            rows = np.asarray(ftypes) == f
        out[rows, 0] = f
        out[rows, 1:] = cand[rows]
    return out.tobytes()


def png_chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def make_png(pix: np.ndarray, color_type: int, level: int, palette=None,
             trns=None, ftypes=None) -> tuple[bytes, bytes]:
    """(PNG file, its filtered scanlines) for (h, w, ch) samples."""
    h, w, _ = pix.shape
    filtered = filter_scanlines(pix, ftypes)
    out = PNG_SIGNATURE + png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    if palette is not None:
        out += png_chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns.tobytes())
    out += png_chunk(b"IDAT", zlib.compress(filtered, level))
    return out + png_chunk(b"IEND", b""), filtered


def to_rgba(pix: np.ndarray, color_type: int, palette=None, trns=None):
    """The (h, w, 4) RGBA a decoder must give for these samples."""
    h, w, _ = pix.shape
    rgba = np.full((h, w, 4), 255, np.uint8)
    if color_type == 6:
        rgba[:] = pix
    elif color_type == 2:
        rgba[..., :3] = pix
    elif color_type == 0:
        rgba[..., :3] = pix
    elif color_type == 4:
        rgba[..., :3], rgba[..., 3] = pix[..., :1], pix[..., 1]
    else:
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[: len(trns)] = trns
        rgba[..., :3], rgba[..., 3] = palette[pix[..., 0]], alpha[pix[..., 0]]
    return rgba


def make_corpus(seed: int = 0):
    """The 16-image corpus: [(name, png, expected RGBA, filtered scanlines,
    (h, w, bpp))]."""
    rng = np.random.default_rng(seed)
    corpus = []
    for k, (name, ct, h, w) in enumerate(CORPUS_SPECS):
        ch = PNG_CHANNELS[ct]
        palette = trns = ftypes = None
        pix = smooth_pixels(rng, h, w, ch)
        if ct == 3:
            palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
            trns = rng.integers(0, 256, 64, dtype=np.uint8)
        if name == "cycle":
            ftypes = np.arange(h) % 5
        png, filtered = make_png(pix, ct, 6 + k % 4, palette, trns, ftypes)
        corpus.append((f"{name}{k}", png, to_rgba(pix, ct, palette, trns),
                       filtered, (h, w, ch)))
    return corpus


def big_image_png() -> tuple[bytes, bytes, np.ndarray]:
    """The noisy BIG_SIDE x BIG_SIDE RGBA image (numpy seed 1) as a level-6
    PNG: (PNG, filtered scanlines, pixels)."""
    pix = smooth_pixels(np.random.default_rng(1), BIG_SIDE, BIG_SIDE, 4,
                        noisy=True)
    return (*make_png(pix, 6, 6), pix)


def k4_png(h: int = 4096, w: int = 4096,
           seed: int = 5) -> tuple[bytes, bytes, np.ndarray]:
    """tools/check_4k_unfilter.py's image: (h, w, 4) RGBA from numpy
    ``default_rng(seed)`` (every third row a copy of the first, green 77
    in every other column), filter types cycling 0-4 by row, zlib level 6,
    IDAT chunks of 1 MiB.  Returns (PNG, filtered scanlines, pixels)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    base[::3] = base[0]
    base[:, ::2, 1] = 77
    raw = filter_scanlines(base, np.arange(h) % 5)
    comp = zlib.compress(raw, 6)
    parts = [PNG_SIGNATURE,
             png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))]
    parts += [png_chunk(b"IDAT", comp[i : i + (1 << 20)])
              for i in range(0, len(comp), 1 << 20)]
    parts.append(png_chunk(b"IEND", b""))
    return b"".join(parts), raw, base
