"""The benchmark's traffic generator: one pool of inputs per run, made from
``--seed`` and the parameters of a configuration file and a traffic file.

The general part lives here: the seeded random generators, raw DEFLATE,
PNG filtering and writing, the RGBA a decoder must give, the pool items
and ``make_pool``.  What belongs to one kind of input is a file of its
own, found by name (``parts``): a traffic file's ``input`` names its maker
(``makers/<input>.py``), a configuration's ``text`` or ``pixels`` the
source data (``texts/<text>.py``, ``pixels/<pixels>.py``).

The text, pixel and PNG code is a frozen copy of
``debigulator_tpu_torch/tools/inputs.py`` (``obj_text``, ``make_streams``,
``make_corpus``, ``k4_png``), changed to take its random generators from
the run's seed (one for each image, so images are made in parallel).  It
uses numpy, ``zlib`` and ``struct`` alone, so the program under test never
makes its own inputs.

Every pool item carries the inputs the entry is called with and the
source they were made from (text bytes, or each image's samples), from
which ``reference`` works out what a correct decode returns.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import struct
import zlib

import numpy as np

from benchmark import parts


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A numpy generator for one part of a run's inputs: any whole seed
    (negative or past 64 bits included) and the part's keys."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *keys]))


# ---------------------------------------------------------------------------
# Frozen copy of the program's synthetic inputs
# ---------------------------------------------------------------------------


def rotations(base: bytes, k: int, step: int) -> list[bytes]:
    """The K rotations of ``base`` that ``make_streams`` compresses."""
    out = []
    for i in range(k):
        rot = (i * step) % len(base)
        out.append(base[rot:] + base[:rot])
    return out


def deflate_raw(data: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


PNG_SIGNATURE = bytes([137, 80, 78, 71, 13, 10, 26, 10])
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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


def png_file(w: int, h: int, color_type: int, zdata: bytes, idat_chunk: int,
             palette=None, trns=None) -> bytes:
    """A PNG of one zlib stream, cut into IDAT chunks of ``idat_chunk``."""
    parts = [PNG_SIGNATURE, png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))]
    if palette is not None:
        parts.append(png_chunk(b"PLTE", palette.tobytes()))
    if trns is not None:
        parts.append(png_chunk(b"tRNS", trns.tobytes()))
    parts += [png_chunk(b"IDAT", zdata[i : i + idat_chunk])
              for i in range(0, len(zdata), idat_chunk)]
    parts.append(png_chunk(b"IEND", b""))
    return b"".join(parts)


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


# ---------------------------------------------------------------------------
# Pools
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Image:
    """One PNG of a pool item and what it was made from."""

    png: bytes
    pix: np.ndarray  # (h, w, ch) samples
    color_type: int
    palette: np.ndarray | None
    trns: np.ndarray | None
    zlib_bytes: int  # the IDAT zlib stream's length
    filtered_bytes: int  # h * (1 + w * ch): the inflate's output


@dataclasses.dataclass
class Item:
    """One pool item: ``args`` is what the entry is called with; ``texts``
    or ``images`` what it was made from; the byte counts are the work of
    one call, from the item's own data."""

    args: object
    texts: list[bytes] | None = None
    images: list[Image] | None = None
    in_bytes: int = 0  # compressed bytes the decode reads
    out_bytes: int = 0  # bytes the call delivers (text or RGBA)
    inflated_bytes: int = 0  # bytes the inflate writes (text or scanlines)
    filtered_bytes: int = 0  # scanline bytes the unfilter reads
    raw_bytes: int = 0  # sample bytes the unfilter writes


def text(config: dict, seed: int, k: int) -> bytes:
    """Pool item ``k``'s text: ``texts/<config["text"]>.py`` over
    ``config["text_bytes"]`` bytes."""
    return parts.load("texts", config["text"]).make(
        rng_for(seed, k, 0), int(config["text_bytes"]))


def png_image(config: dict, rng, spec, level: int) -> Image:
    """One image of ``spec`` = [name, color type, height, width]: samples
    from ``pixels/<config["pixels"]>.py``, a random palette and tRNS for
    color type 3, the filter of each row chosen by ``config["filters"]``
    (``adaptive``: the least sum of absolute residuals; ``cycle``: types
    0-4 by row), one zlib stream in IDAT chunks of ``config["idat_chunk"]``
    bytes."""
    _, ct, h, w = spec
    pix = parts.load("pixels", config["pixels"]).make(rng, h, w,
                                                      PNG_CHANNELS[ct])
    palette = trns = None
    if ct == 3:
        palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
        trns = rng.integers(0, 256, 64, dtype=np.uint8)
    mode = config["filters"]
    if mode not in ("adaptive", "cycle"):
        raise ValueError(f"unknown filters {mode!r}")
    filtered = filter_scanlines(pix, np.arange(h) % 5 if mode == "cycle"
                                else None)
    z = zlib.compress(filtered, level)
    return Image(png_file(w, h, ct, z, int(config["idat_chunk"]), palette,
                          trns), pix, ct, palette, trns, len(z),
                 len(filtered))


def images_item(images: list[Image]) -> Item:
    """A pool item of PNGs: ``args`` is the list of files."""
    raw = sum(im.pix.size for im in images)
    filtered = sum(im.filtered_bytes for im in images)
    return Item(args=[im.png for im in images], images=images,
                in_bytes=sum(im.zlib_bytes - 6 for im in images),
                out_bytes=sum(im.pix.shape[0] * im.pix.shape[1] * 4
                              for im in images),
                inflated_bytes=filtered, filtered_bytes=filtered,
                raw_bytes=raw)


def make_pool(config: dict, traffic: dict, seed: int) -> list[Item]:
    """The run's pool: ``traffic["pool"]`` distinct items from ``seed``,
    made by ``makers/<traffic["input"]>.py``, each the same sizes whatever
    the seed.  Items are made on a thread pool (zlib and numpy's large
    operations release the interpreter lock)."""
    make = parts.load("makers", traffic["input"]).make
    n = int(traffic["pool"])
    workers = max(2, min(8, os.cpu_count() or 2))
    with cf.ThreadPoolExecutor(workers) as inner, \
            cf.ThreadPoolExecutor(n) as outer:
        return list(outer.map(
            lambda k: make(config, traffic, seed, k, inner), range(n)))
