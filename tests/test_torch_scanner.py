"""The host side of the port without the native library: the serial Python
inflate, the canonical decode tables and the Python scan, against the JAX
package's and zlib; DBG_NO_NATIVE=1 in a subprocess."""

import subprocess
import sys
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
