"""Merged plans through the speculative and previous-generation drivers,
and the host codecs on the serial Python inflate, against the JAX
package's and zlib (device="cpu": the kernels' plain versions)."""

import gzip
import struct
import zlib

import numpy as np
import pytest
import torch

from debigulator_tpu.models import gzip_codec as jgz
from debigulator_tpu.models import pipeline as jpl
from debigulator_tpu.models import png_codec as jpng
from debigulator_tpu.ops import inflate_v3 as v3
from debigulator_tpu.ops.scanner import scan_stream_cells
from debigulator_tpu.parallel import merged as jm
from debigulator_tpu_torch.models import gzip_codec as tgz
from debigulator_tpu_torch.models import pipeline as tpl
from debigulator_tpu_torch.models import png_codec as tpng
from debigulator_tpu_torch.models import zlib_codec as tz
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import inflate_ref
from debigulator_tpu_torch.parallel import merged as tm
from torch_stream_cases import STREAMS, ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


FOUR = ["dynamic", "mixed", "rle", "flushed"]


@pytest.fixture(scope="module")
def four():
    streams = [STREAMS[n]() for n in FOUR]
    return streams, [zlib.decompress(s, -15) for s in streams]


def _split(body, mp):
    flat = np.asarray(body[: mp.plan.out_size]).astype(np.uint8)
    return [flat[o : o + n].tobytes()
            for o, n in zip(mp.out_offsets, mp.out_sizes)]


def test_speculative_prepare_merged(four, monkeypatch):
    """Four streams indexed by the Python scan: a speculative merged plan,
    decoded through v5 (the fixpoint runs across the merged cells), equal
    to the reference's speculative merged decode."""
    streams, datas = four
    monkeypatch.setenv("DBG_NO_NATIVE", "1")
    mp = tm.build_merged_plan(streams)
    assert not mp.plan.exact_entries and not mp.plan.slots_exact
    calls = []
    real = inf.inflate_v5
    monkeypatch.setattr(inf, "inflate_v5",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    run = tm.prepare_merged(mp, device="cpu")
    # "rle" packs 27 tokens into a cell: the probe at 16 slots overflows
    # and the runner settles on CELL_BITS slots once.
    assert calls == [16, 64]
    assert _split(run().numpy(), mp) == datas
    assert calls == [16, 64, 64]
    with pytest.raises(RuntimeError, match="native scanner"):
        tm.decode_merged(streams, device="cpu")
    monkeypatch.delenv("DBG_NO_NATIVE")

    scanned = [scan_stream_cells(s, v3.CELL_BITS) for s in streams]
    ref_mp = jm.build_merged_plan(
        streams, records=False, scanned=[(b, ln, None) for b, ln, _ in scanned])
    assert not ref_mp.plan.exact_entries
    assert np.array_equal(ref_mp.plan.cell_entry, mp.plan.cell_entry)
    want = jm.prepare_merged(ref_mp, interpret=True)()
    assert _split(want, ref_mp) == datas


def test_speculative_prepare_merged_probe_without_overflow(monkeypatch):
    """No cell holds more than 16 tokens: one probe, and the runner keeps
    the plan's slots."""
    streams = [STREAMS["mixed"](), STREAMS["dynamic"]()]
    monkeypatch.setenv("DBG_NO_NATIVE", "1")
    mp = tm.build_merged_plan(streams)
    calls = []
    real = inf.inflate_v5
    monkeypatch.setattr(inf, "inflate_v5",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    run = tm.prepare_merged(mp, device="cpu")
    assert calls == [16]
    assert _split(run().numpy(), mp) == [zlib.decompress(s, -15) for s in streams]
    assert calls == [16, 16]


def test_v13_prepare_merged(four, monkeypatch):
    streams, datas = four
    monkeypatch.setenv("DBG_PHASE_B", "v13")
    mp = tm.build_merged_plan(streams)
    assert mp.plan.exact_entries
    calls = []
    real = inf.inflate_v13
    monkeypatch.setattr(inf, "inflate_v13",
                        lambda *a, **k: calls.append("v13") or real(*a, **k))
    monkeypatch.setattr(inf, "flagship_body",
                        lambda *a, **k: calls.append("flagship"))
    got = tm.prepare_merged(mp, device="cpu")()
    assert calls == ["v13"]
    assert _split(got.numpy(), mp) == datas
    assert tm.decode_merged(streams, device="cpu") == datas
    # The reference cannot cover "flushed" with its paged Phase A (too many
    # blocks in a tile), so it is held to the other three.
    ref_mp = jm.build_merged_plan(streams[:3], records=False)
    want = jm.prepare_merged(ref_mp, interpret=True)()
    mp3 = tm.build_merged_plan(streams[:3])
    got3 = tm.prepare_merged(mp3, device="cpu")()
    assert np.array_equal(got3.numpy()[: mp3.plan.out_size],
                          np.asarray(want)[: mp3.plan.out_size])


def test_flagship_needs_exact_slots(four):
    streams, _ = four
    mp = tm.build_merged_plan(streams)
    mp.plan.slots_exact = False
    st = inf.stage_plan(mp.plan, torch.device("cpu"))
    with pytest.raises(ValueError, match="exact slot"):
        inf.flagship_body(st)


# ---------------------------------------------------------------------------
# Host codecs on the Python inflate
# ---------------------------------------------------------------------------


def _png(pix):
    h, w, _ = pix.shape
    raw = b"".join(b"\x00" + pix[r].tobytes() for r in range(h))

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(
            ">I", zlib.crc32(t + p))

    return (bytes([137, 80, 78, 71, 13, 10, 26, 10])
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def test_decode_png_and_zlib_default_to_the_python_inflate(monkeypatch):
    calls = []
    real = inflate_ref.inflate
    for mod in (tpng, tz):
        monkeypatch.setattr(
            mod, "_inflate", lambda d, **k: calls.append(len(d)) or real(d, **k))
    rng = np.random.default_rng(3)
    pix = (rng.integers(0, 4, (12, 9, 4)) * 60).astype(np.uint8)
    png = _png(pix)
    got = tpng.decode_png(png)
    assert np.array_equal(got, pix) and np.array_equal(got, jpng.decode_png(png))
    blob = zlib.compress(b"zlib through the python inflate " * 50)
    assert tz.decode_zlib(blob) == zlib.decompress(blob)
    assert len(calls) == 2
    bad = bytearray(blob)
    bad[-1] ^= 1
    with pytest.raises(tz.ZlibError, match="Adler"):
        tz.decode_zlib(bytes(bad))


@pytest.fixture(scope="module")
def two_members():
    m1 = b"first member " * 300
    m2 = bytes(np.random.default_rng(4).integers(0, 7, 4000, dtype=np.uint8))
    return gzip.compress(m1, 6) + gzip.compress(m2, 9), m1 + m2


def test_host_gzip_two_members(two_members):
    blob, data = two_members
    assert tgz.decode_gzip(blob) == jgz.decode_gzip(blob) == data
    got = tgz.index_members_exact(blob)
    want = jgz.index_members_exact(blob)
    assert len(got) == 2
    assert [vars(m) for m in got] == [vars(m) for m in want]
    assert [vars(m) for m in tgz.parse_gzip_members(blob)] == [vars(m) for m in got]
    one = gzip.compress(data[:1000])
    assert vars(tgz.parse_first_member(one)) == vars(jgz.parse_first_member(one))
    assert got[1].header_start == got[0].deflate_end + 8


def test_host_gzip_errors(two_members):
    blob, _ = two_members
    bad = bytearray(blob)
    bad[-6] ^= 0xFF
    with pytest.raises(tgz.GzipError, match="CRC"):
        tgz.decode_gzip(bytes(bad))
    assert tgz.decode_gzip(bytes(bad), verify=False)
    with pytest.raises(tgz.GzipError, match="empty"):
        tgz.decode_gzip(b"")
    with pytest.raises(tgz.GzipError, match="truncated gzip footer"):
        tgz.index_members_exact(blob[:-4])


def test_decode_corpus_host_mode(tmp_path, two_members, monkeypatch):
    """device="host": PNG and gzip through the host codecs, no tensor
    work; equal to the reference's device=False mode."""
    blob, data = two_members
    pix = np.arange(6 * 5 * 4, dtype=np.uint8).reshape(6, 5, 4)
    (tmp_path / "a.png").write_bytes(_png(pix))
    (tmp_path / "b.gz").write_bytes(blob)
    (tmp_path / "c.gz").write_bytes(blob[:-3])
    (tmp_path / "d.txt").write_bytes(b"?")
    paths = sorted(tmp_path.iterdir())
    monkeypatch.setattr(tpl, "decode_png_device", None)
    monkeypatch.setattr(tpl, "decode_gzip_device", None)
    got = tpl.decode_corpus(paths, device="host")
    want = jpl.decode_corpus(paths, device=False)
    assert [(r.name, r.good) for r in got] == [(r.name, r.good) for r in want]
    assert [r.good for r in got] == [True, True, False, False]
    assert np.array_equal(got[0].data, pix) and np.array_equal(want[0].data, pix)
    assert got[1].data == want[1].data == data
    assert got[2].error == want[2].error
