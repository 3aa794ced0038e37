"""The host side of the port without the native library: the serial Python
inflate, the canonical decode tables and the Python scan, against the JAX
package's and zlib; DBG_NO_NATIVE=1 in a subprocess."""

import subprocess
import sys
import threading
import zlib

import numpy as np
import pytest

from debigulator_tpu.ops import huffman as jh
from debigulator_tpu.ops import inflate_ref as jr
from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.ops import huffman as th
from debigulator_tpu_torch.ops import inflate_ref as tr
from debigulator_tpu_torch.ops import scanner as ts
from torch_stream_cases import STREAMS, ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


CASES = sorted(STREAMS)


@pytest.mark.parametrize("name", CASES)
def test_inflate_matches_reference_and_zlib(name):
    stream = STREAMS[name]()
    out, blocks = tr.inflate(stream)
    want, want_blocks = jr.inflate(stream)
    assert out == want == zlib.decompress(stream, -15)
    assert [vars(b) for b in blocks] == [vars(b) for b in want_blocks]
    assert [vars(b) for b in tr.scan_blocks(stream)] == [vars(b) for b in blocks]


@pytest.mark.parametrize("name", CASES)
def test_python_scan_matches_native_scan(name):
    """Block for block: the same index, and the same code lengths up to
    the native scan's zero padding to 288 and 32 symbols."""
    stream = STREAMS[name]()
    blocks, lengths = ts._scan_stream_py(stream)
    n_blocks, n_lengths = ts.scan_stream(stream)
    assert [vars(b) for b in blocks] == [vars(b) for b in n_blocks]
    for got, want in zip(lengths, n_lengths, strict=True):
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want, strict=True):
            g = np.asarray(g)
            assert np.array_equal(g, w[: len(g)]) and not w[len(g):].any()


def test_read_dynamic_lengths_matches_reference():
    stream = STREAMS["dynamic"]()
    assert (stream[0] >> 1) & 3 == C.BTYPE_DYNAMIC
    got = tr.read_dynamic_lengths(tr._BitReader(stream, 3))
    want = jr.read_dynamic_lengths(jr._BitReader(stream, 3))
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g, w)
    assert got[0][256] > 0  # an end-of-block code


@pytest.mark.parametrize("lengths", [
    C.fixed_litlen_lengths(), C.fixed_dist_lengths(),
    np.array([2, 1, 3, 3]), np.array([0, 0, 5, 0, 5]), np.zeros(4, np.int32)],
    ids=["fixed_litlen", "fixed_dist", "complete", "incomplete", "empty"])
def test_build_decode_table_matches_reference(lengths):
    got, want = th.build_decode_table(lengths), jh.build_decode_table(lengths)
    for f in ("count", "first_code", "index_base", "syms"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.max_len, got.min_len, got.complete) == \
        (want.max_len, want.min_len, want.complete)


def test_one_copy_of_each_error_class():
    from debigulator_tpu_torch.ops import deflate_encode, plan

    assert tr.HuffmanError is th.HuffmanError is plan.HuffmanError
    assert deflate_encode.HuffmanError is th.HuffmanError
    with pytest.raises(th.HuffmanError, match="over-subscribed"):
        th.build_decode_table(np.array([1, 1, 1]))
    with pytest.raises(th.HuffmanError, match="out of range"):
        th.build_decode_table(np.array([16]))


@pytest.mark.parametrize("bad,match", [
    (lambda s: s[: len(s) // 2], "unexpected end"),
    (lambda s: b"\x07" + s[1:], "invalid block type"),
    (lambda s: b"", "unexpected end"),
], ids=["truncated", "btype3", "empty"])
def test_corrupt_streams_raise(bad, match):
    stream = bad(STREAMS["dynamic"]())
    with pytest.raises(tr.InflateError, match=match):
        tr.inflate(stream)
    with pytest.raises(jr.InflateError, match=match):
        jr.inflate(stream)


def test_stored_len_mismatch_and_far_distance_raise():
    stream = bytearray(STREAMS["stored"]())
    stream[3] ^= 0xFF
    with pytest.raises(tr.InflateError, match="LEN/NLEN"):
        tr.inflate(bytes(stream))
    from torch_stream_cases import fixed_block

    with pytest.raises(tr.InflateError, match="too far back"):
        tr.inflate(fixed_block([(65, 0, 0), (-1, 3, 2)]))
    with pytest.raises(tr.InflateError, match="caller capacity"):
        tr.inflate(STREAMS["rle"](), max_output=100)


_NO_NATIVE = """
import sys, zlib
import numpy as np
from debigulator_tpu_torch import native
from debigulator_tpu_torch.ops import checksum, plan, scanner
from debigulator_tpu_torch.ops.inflate import inflate_device
data = b"no native library " * 400 + bytes(range(256)) * 4
c = zlib.compressobj(6, zlib.DEFLATED, -15)
raw = c.compress(data) + c.flush()
assert native.disabled()
try:
    native.get_lib()
except RuntimeError as e:
    assert "DBG_NO_NATIVE" in str(e)
else:
    raise SystemExit("get_lib must raise")
blocks, lengths, cells = scanner.scan_stream_cells(raw, plan.CELL_BITS)
assert cells is None and len(blocks) >= 1
assert scanner.scan_stream(raw)[0] == blocks
p = plan.build_plan_v3(raw, blocks, lengths, cells=cells)
assert not p.exact_entries and not p.slots_exact and p.slots == plan.DEFAULT_SLOTS
assert inflate_device(raw, device="cpu") == data
assert checksum.crc32(data) == zlib.crc32(data)
assert checksum.adler32(data) == zlib.adler32(data)
from debigulator_tpu_torch.models.pipeline import decode_gzip_device
import gzip
assert decode_gzip_device(gzip.compress(data), device="cpu") == data
assert not any(k == "jax" or k.startswith("debigulator_tpu.") for k in sys.modules)
print("NO_NATIVE_OK")
"""


def test_dbg_no_native_in_a_subprocess():
    import os

    env = dict(os.environ, DBG_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", _NO_NATIVE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_NATIVE_OK" in r.stdout


def test_native_is_the_default(monkeypatch):
    from debigulator_tpu_torch import native

    monkeypatch.delenv("DBG_NO_NATIVE", raising=False)
    assert not native.disabled()
    stream = STREAMS["dynamic"]()
    _, _, cells = ts.scan_stream_cells(stream, 64)
    assert cells is not None and len(cells) == 3
    monkeypatch.setenv("DBG_NO_NATIVE", "1")  # read at call time
    assert ts.scan_stream_cells(stream, 64)[2] is None


def _scan_arrays(scanned):
    """Every array of a (blocks, lengths, cells) scan."""
    _, lengths, (states, pend, _) = scanned
    return [a for pair in lengths if pair is not None for a in pair] + [
        states, pend]


def _assert_same_scan(got, want):
    assert [vars(b) for b in got[0]] == [vars(b) for b in want[0]]
    for g, w in zip(got[1], want[1], strict=True):
        assert (g is None) == (w is None)
        if w is not None:
            assert all(np.array_equal(a, b) for a, b in zip(g, w, strict=True))
    (gs, gp, gm), (ws, wp, wm) = got[2], want[2]
    assert np.array_equal(gs, ws) and np.array_equal(gp, wp) and gm == wm


def _in_place_forms(stream: bytes, tail: bytes):
    """``stream`` with ``tail`` behind it as each buffer the scan takes."""
    whole = stream + tail
    return {"bytes": whole, "bytearray": bytearray(whole),
            "memoryview": memoryview(b"\x1f\x8b\x08" + whole)[3:],
            "numpy": np.frombuffer(b"\0" * 5 + whole, np.uint8)[5:]}


@pytest.mark.parametrize("name", CASES)
def test_scan_in_place_ignores_what_follows_the_stream(name):
    """The scan of a stream alone, of the stream with a second member and
    random bytes behind it, in every buffer form, and the JAX package's
    scan agree block for block and cell for cell; every array a scan
    returns is its own, and two scans in a row share no memory."""
    from debigulator_tpu.ops.scanner import scan_stream_cells as ref_scan
    from debigulator_tpu_torch.ops.plan import CELL_BITS

    stream = STREAMS[name]()
    alone = ts.scan_stream_cells(stream, CELL_BITS)
    _assert_same_scan(alone, ref_scan(stream, CELL_BITS))
    tail = STREAMS["dynamic"]() + np.random.default_rng(9).integers(
        0, 256, 50_000, dtype=np.uint8).tobytes()
    for form, buf in _in_place_forms(stream, tail).items():
        got = ts.scan_stream_cells(buf, CELL_BITS)
        _assert_same_scan(got, alone)
        assert (got[0][-1].end_bit + 7) // 8 == len(stream), form
    again = ts.scan_stream_cells(stream, CELL_BITS)
    for a in _scan_arrays(alone):
        assert a.flags.owndata
        assert not any(np.shares_memory(a, b) for b in _scan_arrays(again))


class _PoisonedEmpty:
    """numpy with ``empty`` returning 0xA5 bytes in place of whatever
    memory held before: a scan may read only what the native side wrote,
    in a fresh scratch as in one a longer scan left behind."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def empty(shape, dtype=float):
        a = np.zeros(shape, dtype)
        a.view(np.uint8)[...] = 0xA5
        return a


@pytest.mark.parametrize("name", CASES)
def test_scan_reads_only_what_the_native_scan_wrote(name, monkeypatch):
    from debigulator_tpu_torch.native import scanner as ns
    from debigulator_tpu_torch.ops.plan import CELL_BITS

    stream = STREAMS[name]()
    want = ts.scan_stream_cells(stream, CELL_BITS)
    monkeypatch.setattr(ns, "np", _PoisonedEmpty())
    monkeypatch.setattr(ns, "_SCRATCH", threading.local())
    _assert_same_scan(ts.scan_stream_cells(stream + b"\xff" * 999, CELL_BITS),
                      want)
    ts.scan_stream_cells(STREAMS["flushed"]() + b"\0" * 99_999, CELL_BITS)
    _assert_same_scan(ts.scan_stream_cells(stream, CELL_BITS), want)
    out, blocks = ns.inflate_native(stream)
    assert out == zlib.decompress(stream, -15)
    assert [vars(b) for b in blocks] == [vars(b) for b in want[0]]


def test_many_tiny_blocks_in_place_grow_and_retry(monkeypatch):
    """A member of hundreds of tiny blocks (a full flush every 3 bytes)
    with a tail twice its length behind it: the first block buffer, sized
    by the whole buffer, is too small, and the scan grows it and gives the
    same index as the member alone and as the JAX package."""
    from debigulator_tpu.ops.scanner import scan_stream_cells as ref_scan
    from debigulator_tpu_torch.native import scanner as ns
    from debigulator_tpu_torch.ops.plan import CELL_BITS

    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = b"tiny blocks, one flush each " * 40
    member = b"".join(c.compress(data[i : i + 3]) + c.flush(zlib.Z_FULL_FLUSH)
                      for i in range(0, len(data), 3)) + c.flush()
    tail = np.random.default_rng(4).integers(
        0, 256, 2 * len(member), dtype=np.uint8).tobytes()
    lib = ns.get_lib()
    codes = []

    class Lib:
        def dbg_scan(self, *args):
            codes.append(lib.dbg_scan(*args))
            return codes[-1]

    monkeypatch.setattr(ns, "get_lib", Lib)
    got = ts.scan_stream_cells(memoryview(member + tail), CELL_BITS)
    assert codes[0] == -2 and codes[-1] == len(got[0]) > 64
    assert len(got[0]) > (len(member) + len(tail)) // 16 + 16
    _assert_same_scan(got, ts.scan_stream_cells(member, CELL_BITS))
    _assert_same_scan(got, ref_scan(member, CELL_BITS))
    assert zlib.decompress(member, -15) == data
