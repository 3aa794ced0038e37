"""The generator: the same seed gives the same inputs, another seed other
inputs of the same sizes, and a pool's items differ from each other."""

from __future__ import annotations

import hashlib
import struct
import zlib

import pytest

from benchmark import inputs
from benchmark.tests.small import small_cell, workloads


def _digest(pool) -> list[str]:
    out = []
    for item in pool:
        args = item.args if isinstance(item.args, list) else [item.args]
        h = hashlib.sha256()
        for a in args:
            h.update(a)
        out.append(h.hexdigest())
    return out


def _pool(name, seed):
    cell = small_cell(name)
    return inputs.make_pool(cell.config, cell.traffic, seed)


@pytest.mark.parametrize("name", workloads())
def test_deterministic_and_seeded(name):
    a, b = _pool(name, 2**31 + 7), _pool(name, 2**31 + 7)
    c = _pool(name, 12)
    assert _digest(a) == _digest(b)
    assert set(_digest(a)).isdisjoint(_digest(c))
    assert len(set(_digest(a))) == len(a) >= 2  # the pool's items differ
    # Another seed, the same work: the bytes every call delivers.
    assert [i.out_bytes for i in a] == [i.out_bytes for i in c]
    assert [i.inflated_bytes for i in a] == [i.inflated_bytes for i in c]


def test_any_whole_seed():
    for seed in (0, -5, 2**31 + 1, 2**64 + 3):
        inputs.rng_for(seed, 1).integers(0, 9)


def test_bgzf_layout():
    cell = small_cell("gz-text.bgzf")
    (item,) = inputs.make_pool(cell.config, {**cell.traffic, "pool": 1}, 3)
    data = item.args
    # Members of 65,280 bytes of text (here 5,000), each with BC, and the
    # 28-byte empty end-of-file member of the SAM/BAM specification.
    assert data.endswith(bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"))
    text = item.texts[0]
    n = -(-len(text) // cell.traffic["block_bytes"]) + 1
    at, members = 0, 0
    while at < len(data):
        assert data[at : at + 4] == b"\x1f\x8b\x08\x04"
        assert data[at + 12 : at + 14] == b"BC"
        bsize = int.from_bytes(data[at + 16 : at + 18], "little") + 1
        at += bsize
        members += 1
    assert at == len(data) and members == n
    import gzip

    assert gzip.decompress(data) == text


def test_png_layout():
    """Every image of a pool item is a PNG of its spec whose chunks carry
    their CRC-32, in IDAT chunks of the configured size, and whose stream
    inflates to the image's filtered rows (filter types 0-4 by row where
    the configuration cycles them)."""
    for name in ("png-corpus.decode", "png-4k.single"):
        cell = small_cell(name)
        (item,) = inputs.make_pool(cell.config, {**cell.traffic, "pool": 1}, 6)
        specs = cell.config["images"]
        assert len(item.args) == len(item.images) == len(specs)
        for png, im, (_, ct, h, w) in zip(item.args, item.images, specs):
            assert png.startswith(inputs.PNG_SIGNATURE)
            at, idat = 8, []
            while at < len(png):
                n, kind = struct.unpack(">I4s", png[at : at + 8])
                body = png[at + 8 : at + 8 + n]
                assert png[at + 8 + n : at + 12 + n] == struct.pack(
                    ">I", zlib.crc32(kind + body))
                if kind == b"IHDR":
                    assert struct.unpack(">IIBB", body[:10]) == (w, h, 8, ct)
                elif kind == b"IDAT":
                    idat.append(body)
                at += 12 + n
            assert {len(b) for b in idat[:-1]} <= {cell.config["idat_chunk"]}
            rows = zlib.decompress(b"".join(idat))
            assert len(rows) == im.filtered_bytes == h * (1 + w * im.pix.shape[2])
            if cell.config["filters"] == "cycle":
                stride = len(rows) // h
                assert [rows[r * stride] for r in range(h)] == \
                    [r % 5 for r in range(h)]
