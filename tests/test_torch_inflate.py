"""End-to-end decode of the PyTorch port on device="cpu" (the kernels'
plain PyTorch versions): a single stream against the JAX flagship and
zlib, then larger shapes against zlib / gzip only (bit-exact)."""

import gzip
import struct
import zlib

import numpy as np
import pytest

from debigulator_tpu_torch.models.gzip_codec import GzipError
from debigulator_tpu_torch.models.pipeline import decode_gzip_device
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import plan as tp
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
from debigulator_tpu_torch.parallel.merged import (
    build_merged_plan,
    decode_merged,
    prepare_merged,
)


def _deflate(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(data) + c.flush()


def _words(n, seed=4, words=(b"merge ", b"batch ", b"op ", b"tape ", b"\n")):
    rng = np.random.default_rng(seed)
    return b"".join(words[int(v) % len(words)]
                    for v in rng.integers(0, len(words), n))


def test_single_stream_matches_jax_flagship_and_zlib():
    from debigulator_tpu.ops.inflate_v3 import inflate_device_v3

    data = _words(5000) + b"q" * 3000 + _words(2000, seed=5)
    stream = _deflate(data)
    got = inf.inflate_device(stream, device="cpu")
    assert got == data
    assert got == inflate_device_v3(stream, force_pallas=True)


def test_multi_segment_stream():
    data = _words(200_000, seed=6)
    assert len(data) > tp.SEG_BYTES  # two segments of the body
    assert inf.inflate_device(_deflate(data, 9), device="cpu") == data


def test_stored_only_stream():
    data = np.random.default_rng(1).integers(0, 256, 70_000,
                                             dtype=np.uint8).tobytes()
    stream = _deflate(data, 0)
    body, n = inf.inflate_device_dev(stream, device="cpu")
    assert n == len(data)
    assert body[:n].numpy().astype(np.uint8).tobytes() == data


def test_long_stream_chunked_window_carry():
    """A forced small cap splits the stream into block-aligned chunks;
    matches crossing a chunk boundary read the carried 32 KiB window."""
    rng = np.random.default_rng(5)
    data = (bytes(rng.integers(0, 64, 600_000, dtype=np.uint8))
            + b"repeat me " * 6000)
    stream = _deflate(data)
    blocks, lengths, cells = scan_stream_cells(stream, tp.CELL_BITS)
    assert len(blocks) >= 3
    out, n = inf.inflate_device_long_stream(stream, blocks, lengths, cells,
                                            cap_rows=4096, device="cpu")
    assert out[:n].numpy().astype(np.uint8).tobytes() == data


def test_single_block_over_cap_raises():
    data = _words(40_000, seed=8)
    stream = _deflate(data)
    blocks, lengths, cells = scan_stream_cells(stream, tp.CELL_BITS)
    with pytest.raises(inf.SingleBlockTooLarge):
        inf.inflate_device_long_stream(stream, blocks, lengths, cells,
                                       cap_rows=16, device="cpu")


def test_single_block_over_cap_takes_the_native_fallback(monkeypatch):
    """With the per-call cap shrunk, a one-block stream is too large for
    one call and cannot be split at a block boundary: the entry point
    decodes it with the native serial inflate and stages the result."""
    data = _words(40_000, seed=8)
    stream = _deflate(data)
    assert len(scan_stream_cells(stream, tp.CELL_BITS)[0]) == 1
    monkeypatch.setattr(tp, "LIT_ROW_CAP", 16)
    calls = []
    real = inf.inflate_native
    monkeypatch.setattr(inf, "inflate_native",
                        lambda d: calls.append(len(d)) or real(d))
    body, n = inf.inflate_device_dev(stream, device="cpu")
    assert calls == [len(stream)]
    assert body.dtype.is_floating_point is False and n == len(data)
    assert body[:n].numpy().astype(np.uint8).tobytes() == data
    assert inf.inflate_device(stream, device="cpu") == zlib.decompress(stream, -15)


def test_native_inflate_matches_zlib_and_the_scan():
    from debigulator_tpu_torch.native.scanner import inflate_native

    data = _words(30_000, seed=9) + bytes(
        np.random.default_rng(2).integers(0, 256, 70_000, dtype=np.uint8))
    stream = _deflate(data, 6)
    out, blocks = inflate_native(stream)
    assert out == data
    scanned = scan_stream_cells(stream, tp.CELL_BITS)[0]
    assert [vars(b) for b in blocks] == [vars(b) for b in scanned]


def test_decode_merged_three_streams():
    datas = [_words(8000 + 500 * i, seed=10 + i) for i in range(3)]
    streams = [_deflate(d, level=1 + 3 * i) for i, d in enumerate(datas)]
    assert decode_merged(streams, device="cpu") == datas


def test_prepare_merged_runner_is_reusable():
    datas = [_words(3000, seed=20), b"z" * 7000 + _words(1000, seed=21)]
    mp = build_merged_plan([_deflate(d) for d in datas])
    run = prepare_merged(mp, device="cpu")
    first = run()[: mp.plan.out_size].numpy().astype(np.uint8)
    again = run()[: mp.plan.out_size].numpy().astype(np.uint8)
    assert np.array_equal(first, again)
    for off, size, d in zip(mp.out_offsets, mp.out_sizes, datas):
        assert first[off : off + size].tobytes() == d


def test_gzip_two_members():
    m1, m2 = _words(6000, seed=30), b"second member " * 900
    blob = gzip.compress(m1, 6) + gzip.compress(m2, 9)
    assert decode_gzip_device(blob, device="cpu") == gzip.decompress(blob)


def test_gzip_corrupt_crc_raises():
    blob = bytearray(gzip.compress(_words(2000, seed=31)))
    blob[-8] ^= 0xFF
    with pytest.raises(GzipError, match="CRC"):
        decode_gzip_device(bytes(blob), device="cpu")


def _bgzf_member(block: bytes, level: int = 6) -> bytes:
    """A BGZF block (SAM/BAM specification 4.1): a gzip member whose
    FEXTRA holds the ``BC`` subfield, the member's size less one."""
    body = _deflate(block, level)
    extra = b"BC" + struct.pack("<HH", 2, len(body) + 25)
    return (b"\x1f\x8b\x08\x04\0\0\0\0\0\xff" + struct.pack("<H", len(extra))
            + extra + body + struct.pack("<II", zlib.crc32(block), len(block)))


def _named_member(block: bytes) -> bytes:
    """A gzip member with FNAME and FCOMMENT."""
    return (b"\x1f\x8b\x08\x18\0\0\0\0\0\x03" + b"member.obj\0"
            + b"a comment, then the stream\0" + _deflate(block, 9)
            + struct.pack("<II", zlib.crc32(block), len(block)))


def _gzip_file(kind: str) -> bytes:
    texts = [_words(1500 + 400 * i, seed=40 + i) for i in range(4)]
    if kind == "bgzf":
        return b"".join(map(_bgzf_member, texts + [b""]))  # + the EOF block
    if kind == "plain":
        return b"".join(gzip.compress(t, 1 + 2 * i) for i, t in enumerate(texts))
    return _named_member(texts[0]) + gzip.compress(texts[1])


@pytest.mark.parametrize("kind", ["bgzf", "plain", "fname_fcomment"])
def test_gzip_members_scanned_in_place(kind):
    """Each member's scan is handed the rest of the file where it lies:
    the decode is bit-exact, and the scan counters read more bytes handed
    in than read."""
    blob = _gzip_file(kind)
    count = scan_stream_cells
    calls, given, read = count.calls, count.bytes_given, count.bytes_read
    assert decode_gzip_device(bytearray(blob), device="cpu") == \
        gzip.decompress(blob)
    n = count.calls - calls
    assert n == {"bgzf": 5, "plain": 4, "fname_fcomment": 2}[kind]
    assert count.bytes_given - given > count.bytes_read - read + 8 * n


def test_scan_counters_on_a_single_member():
    """One raw stream: handed and read are equal; one gzip member (a
    10-byte header): they differ by the 8-byte footer behind the stream."""
    data = _words(3000, seed=50)
    stream, member = _deflate(data), gzip.compress(data)
    count = scan_stream_cells
    for blob, decode, n_given, n_read in [
            (stream, inf.inflate_device, len(stream), len(stream)),
            (member, decode_gzip_device, len(member) - 10, len(member) - 18)]:
        calls, given, read = count.calls, count.bytes_given, count.bytes_read
        assert decode(blob, device="cpu") == data
        assert count.calls - calls == 1
        assert count.bytes_given - given == n_given
        assert count.bytes_read - read == n_read


def _flip(blob: bytes, at: int) -> bytes:
    return blob[:at] + bytes([blob[at] ^ 1]) + blob[at + 1 :]


@pytest.mark.parametrize("kind,fault,match", [
    ("bgzf", lambda b: b[:-3], "no room for payload\\+footer"),
    ("plain", lambda b: b[:-3], "truncated gzip footer"),
    # The EOF member is 28 bytes, so the last data member's footer
    # (CRC-32, then ISIZE) starts 36 bytes before the file's end.
    ("bgzf", lambda b: _flip(b, len(b) - 36), "CRC-32 mismatch"),
    ("plain", lambda b: _flip(b, len(b) - 8), "CRC-32 mismatch"),
], ids=["bgzf_truncated", "plain_truncated", "bgzf_crc", "plain_crc"])
def test_gzip_faults_raise(kind, fault, match):
    """A file cut inside its last footer, or with a data member's CRC-32
    flipped, raises: the in-place scan checks every member's footer."""
    with pytest.raises(GzipError, match=match):
        decode_gzip_device(fault(_gzip_file(kind)), device="cpu")
