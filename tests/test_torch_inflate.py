"""End-to-end decode of the PyTorch port on device="cpu" (the kernels'
plain PyTorch versions): a single stream against the JAX flagship and
zlib, then larger shapes against zlib / gzip only (bit-exact)."""

import gzip
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
