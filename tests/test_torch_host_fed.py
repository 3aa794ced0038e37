"""The host-fed v10 decode of the PyTorch port (record scan, group packer,
piece words, merged records, the v11 group resolver and inflate_v10)
against the JAX package (Pallas in interpret mode) and zlib, on
device="cpu" (the kernel's plain version).  Bit-exact everywhere."""

import dataclasses
import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debigulator_tpu.native import scanner as ref_native
from debigulator_tpu.ops import inflate_v3 as v3
from debigulator_tpu.ops import lz77_pallas as ref_lz
from debigulator_tpu.ops.archive import host_fed as ref_hf
from debigulator_tpu.ops.archive import inflate_generations as ref_ig
from debigulator_tpu.ops.archive import lz77_generations as ref_lzgen
from debigulator_tpu.parallel import merged as ref_merged
from debigulator_tpu_torch.native import scanner as tns
from debigulator_tpu_torch.ops import plan as tp
from debigulator_tpu_torch.ops import scanner as tscan
from debigulator_tpu_torch.ops.archive import host_fed as hf
from debigulator_tpu_torch.ops.archive import inflate_generations as ig
from debigulator_tpu_torch.ops.archive import lz77_generations as lzgen
from debigulator_tpu_torch.parallel import merged as tm
from torch_stream_cases import (
    STREAMS,
    by_segment,
    deflate,
    ensure_reference_native,
    nested_copies,
    segments_init,
    words,
)


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


def _text(seed, n=20000):
    rng = random.Random(seed)
    return "".join(rng.choice("abcdefgh \n") for _ in range(n)).encode()


def _stored_mix():
    """Stored blocks between compressed ones (test_lz77_v9's input)."""
    rng = random.Random(9)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    parts = []
    for i in range(5):
        chunk = (b"repeat me " * 200) if i % 2 else bytes(rng.randbytes(2000))
        parts += [co.compress(chunk), co.flush(zlib.Z_FULL_FLUSH)]
    return b"".join(parts) + co.flush()


def _window_carry():
    """Matches reaching into the previous 512 KiB segment."""
    rng = random.Random(13)
    head = bytes(rng.randbytes(30000))
    return deflate(head + bytes(rng.randbytes(v3.SEG_BYTES - 15000)) + head, 9)


SCAN_CASES = {
    "level1": lambda: deflate(_text(1), 1),
    "level6": lambda: deflate(_text(6), 6),
    "level9": lambda: deflate(_text(9), 9),
    "fixed": lambda: deflate(words(3000, seed=2), 6, zlib.Z_FIXED),
    "stored_mix": _stored_mix,
}


def _np(x):
    return np.asarray(x)


def _blocks(infos):
    return [dataclasses.astuple(b) for b in infos]


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_scan_stream_records(name):
    stream = SCAN_CASES[name]()
    want = ref_native.scan_stream_records(stream, v3.CELL_BITS)
    got = tscan.scan_stream_records(stream, tp.CELL_BITS)
    assert _blocks(got[0]) == _blocks(want[0])
    for g, w in zip(got[1], want[1], strict=True):
        assert (g is None) == (w is None)
        if g is not None:
            assert all(np.array_equal(a, b) for a, b in zip(g, w, strict=True))
    for g, w in zip(got[2], want[2], strict=True):
        assert np.array_equal(g, w)
    assert set(got[3]) == set(want[3])
    for k, w in want[3].items():
        assert np.array_equal(got[3][k], w), k
    assert got[3]["out_size"] == len(zlib.decompress(stream, -15))


def test_scan_stream_records_without_native(monkeypatch):
    """DBG_NO_NATIVE=1: the Python scan, no cells and no records."""
    stream = SCAN_CASES["level6"]()
    want_blocks = ref_native.scan_stream_records(stream, v3.CELL_BITS)[0]
    monkeypatch.setenv("DBG_NO_NATIVE", "1")
    blocks, lengths, cells, recs = tscan.scan_stream_records(stream,
                                                             tp.CELL_BITS)
    assert cells is None and recs is None
    assert _blocks(blocks) == _blocks(want_blocks)
    assert len(lengths) == len(blocks)


@pytest.mark.parametrize("name,seg_bytes", [
    ("level6", v3.SEG_BYTES), ("level9", 4096), ("rle", 2048),
    ("far", 8192)])
def test_pack_groups(name, seg_bytes):
    stream = (SCAN_CASES[name] if name in SCAN_CASES else STREAMS[name])()
    recs = ref_native.scan_stream_records(stream, v3.CELL_BITS)[3]
    n_seg = -(-recs["out_size"] // seg_bytes)
    want = ref_native.pack_groups(recs["m_pos"], recs["m_meta"], seg_bytes,
                                  n_seg)
    got = tns.pack_groups(recs["m_pos"], recs["m_meta"], seg_bytes, n_seg)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _merged_cases():
    return {
        "one": [SCAN_CASES["level6"]()],
        "batch": [STREAMS[k]() for k in ("dynamic", "mixed", "rle", "far")],
        "with_empty": [deflate(b"a" * 30000), deflate(b""), _stored_mix(),
                       deflate(words(4000, seed=3), 9)],
    }


@pytest.mark.parametrize("case", ["one", "batch", "with_empty"])
def test_build_merged_plan_records(case):
    streams = _merged_cases()[case]
    want = ref_merged.build_merged_plan(streams, records=True)
    got = tm.build_merged_plan(streams, records=True)
    assert got.plan.slots == want.plan.slots
    assert got.plan.slots_exact and want.plan.slots_exact
    assert got.out_offsets == want.out_offsets
    assert set(got.recs) == set(want.recs)
    for k, w in want.recs.items():
        assert np.array_equal(got.recs[k], w), k
    assert tm.build_merged_plan(streams).recs is None


def test_records_need_the_native_scan(monkeypatch):
    stream = SCAN_CASES["level1"]()
    scanned = [tscan.scan_stream_cells(stream, tp.CELL_BITS)]
    with pytest.raises(RuntimeError, match="records"):
        tm.build_merged_plan([stream], records=True, scanned=scanned)
    monkeypatch.setenv("DBG_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="records"):
        tm.build_merged_plan([stream], records=True)


def test_pad_rec_rows():
    for n in (0, 1, 128, 2049, 5000):
        a = np.arange(n, dtype=np.int32)
        assert np.array_equal(tm._pad_rec_rows(a, 16),
                              ref_merged._pad_rec_rows(a, 16))


@pytest.mark.parametrize("case,seg_bytes", [
    ("one", None), ("batch", 4096), ("with_empty", 8192)])
def test_build_piece_arrays(case, seg_bytes):
    streams = _merged_cases()[case]
    want_mp = ref_merged.build_merged_plan(streams, records=True)
    got_mp = tm.build_merged_plan(streams, records=True)
    seg = seg_bytes or v3.SEG_BYTES
    n_seg = v3._round_pow2(max(1, -(-want_mp.plan.out_size // seg)), 1)
    want = ref_hf.build_piece_arrays(want_mp.recs, n_seg, seg_bytes=seg)
    got = hf.build_piece_arrays(got_mp.recs, n_seg, seg_bytes=seg,
                                device="cpu")
    assert set(got) == set(want) == {"lims", "gpos", "gmeta", "lpos",
                                     "lmeta", "lit"}
    for k, w in want.items():
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), _np(w)), k


def test_pack_piece_words_contract():
    """The words the v11 kernel unpacks: w0 = dst_row << 16 | rp << 8 |
    rp + len, w1 = q_row << 16 | r << 8 | 128 - r."""
    rng = np.random.default_rng(0)
    dst = rng.integers(0, 1 << 20, 500)
    ln = rng.integers(0, 128 - (dst & 127) + 1)
    src = dst - rng.integers(1, 32769, 500) + 40000
    w0, w1 = hf._pack_piece_words(dst, ln, src)
    r0, r1 = ref_hf._pack_piece_words(dst, ln, src)
    assert np.array_equal(w0, r0) and np.array_equal(w1, r1)
    d, n, s = lzgen.unpack_piece_words(torch.from_numpy(w0),
                                       torch.from_numpy(w1))
    assert np.array_equal(d.numpy(), dst) and np.array_equal(n.numpy(), ln)
    assert np.array_equal(s.numpy(), src)
    with pytest.raises(ValueError, match="load base"):
        hf._pack_piece_words(np.array([5]), np.array([3]), np.array([-1]))


def test_build_v9_arrays_needs_records():
    mp = tm.build_merged_plan([SCAN_CASES["level1"]()])
    with pytest.raises(ValueError, match="records"):
        hf.build_v9_arrays(mp, 1, device="cpu")


@pytest.mark.parametrize("seg", [0, 2])
def test_resolve_groups_v11_one_segment(seg):
    """One segment of a 4 KiB-segment packing, its window the previous
    segment's bytes, through both resolvers."""
    stream = deflate(words(3000, seed=5) + _text(4, 6000), 6)
    data = np.frombuffer(zlib.decompress(stream, -15), np.uint8)
    mp = ref_merged.build_merged_plan([stream], records=True)
    seg_bytes = 4096
    n_seg = -(-len(data) // seg_bytes)
    v9 = ref_hf.build_piece_arrays(mp.recs, n_seg, seg_bytes=seg_bytes)
    w = ref_lz.WINDOW
    init = np.zeros(ref_lz.PAD + w + seg_bytes + 512, np.int32)
    off = seg * seg_bytes
    tail = data[max(0, off - w) : off].astype(np.int32)
    init[ref_lz.PAD + w - len(tail) : ref_lz.PAD + w] = tail
    init = init.reshape(-1, 128)
    lim = _np(v9["lims"])[seg]
    want = ref_lzgen.resolve_groups_v11(
        jnp.asarray(init), jnp.asarray(lim), v9["gpos"], v9["gmeta"],
        v9["lpos"], v9["lmeta"], v9["lit"], seg_bytes=seg_bytes,
        interpret=True)
    t = {k: torch.from_numpy(_np(v).copy()) for k, v in v9.items()}
    got = lzgen.resolve_groups_v11(
        torch.from_numpy(init), torch.from_numpy(lim.copy()), t["gpos"],
        t["gmeta"], t["lpos"], t["lmeta"], t["lit"])
    assert np.array_equal(got.numpy(), _np(want))
    body = got.view(-1)[lzgen.BODY_START : lzgen.BODY_START + seg_bytes]
    n = min(seg_bytes, len(data) - off)
    assert np.array_equal(body[:n].numpy(), data[off : off + n])


#: name -> (data, first segment, segments in the call, odd buffer); 4 KiB
#: segments.
GROUPS_V11_CASES = {
    "zero_run": (lambda: bytes(12_288), 0, 3, False),
    "copies_of_copies": (lambda: nested_copies(12_288), 0, 3, False),
    "segments": (lambda: words(3000, seed=5) + _text(4, 6000), 1, 3, False),
    "odd_init": (lambda: words(3000, seed=5) + _text(4, 6000), 2, 2, True),
}


@pytest.mark.parametrize("name", list(GROUPS_V11_CASES))
def test_resolve_groups_v11_chase_cases(name):
    """What the card's chase changes against the in-order kernel: a zero
    run of dist-1 matches (the packer's doubling pieces), copies of
    copies, several segments in one call (sources in the segment before
    and in the window), and a buffer with -1 in its pad row, bodies and
    slack and values above 255 in its window.  The port's one call over
    the segments against the JAX kernel in interpret mode, one call a
    segment with the window carried; bit-exact, and equal to the data
    where the window is the data."""
    make, k0, n, odd = GROUPS_V11_CASES[name]
    data = make()
    stream = deflate(data, 9)
    flat = np.frombuffer(data, np.uint8)
    seg = 4096
    mp = ref_merged.build_merged_plan([stream], records=True)
    v9 = ref_hf.build_piece_arrays(mp.recs, -(-len(flat) // seg),
                                   seg_bytes=seg)
    lims = _np(v9["lims"])
    init = segments_init(flat, k0, n, seg, odd)

    def ref_call(buf, i):
        return ref_lzgen.resolve_groups_v11(
            jnp.asarray(buf), jnp.asarray(lims[k0 + i]), v9["gpos"],
            v9["gmeta"], v9["lpos"], v9["lmeta"], v9["lit"], seg_bytes=seg,
            interpret=True)

    want = by_segment(ref_call, init, n, seg)
    t = {k: torch.from_numpy(_np(v).copy()) for k, v in v9.items()}
    got = lzgen.resolve_groups_v11(
        torch.from_numpy(init), torch.from_numpy(lims[k0 : k0 + n].copy()),
        t["gpos"], t["gmeta"], t["lpos"], t["lmeta"], t["lit"])
    assert np.array_equal(got.numpy(), want)
    if not odd:
        off = k0 * seg
        m = min(n * seg, len(flat) - off)
        body = got.view(-1)[lzgen.BODY_START : lzgen.BODY_START + m]
        assert np.array_equal(body.numpy(), flat[off : off + m])


V10_CASES = {
    "level1": [SCAN_CASES["level1"]],
    "level6": [SCAN_CASES["level6"]],
    "level9": [SCAN_CASES["level9"]],
    "stored_mix": [_stored_mix],
    "window_carry": [_window_carry],
}


def _v10_inputs(streams):
    mp = tm.build_merged_plan(streams, records=True)
    n_seg = v3._round_pow2(max(1, -(-mp.plan.out_size // v3.SEG_BYTES)), 1)
    return mp, n_seg


@pytest.mark.parametrize("name", list(V10_CASES))
def test_inflate_v10(name):
    streams = [f() for f in V10_CASES[name]]
    ref_mp = ref_merged.build_merged_plan(streams, records=True)
    mp, n_seg = _v10_inputs(streams)
    want = ref_ig._inflate_v10_jit(
        ref_hf.build_v9_arrays(ref_mp, n_seg),
        jnp.asarray(ref_mp.plan.stored_pos), jnp.asarray(ref_mp.plan.stored_val),
        n_seg, interpret=True)
    v9 = hf.build_v9_arrays(mp, n_seg, device="cpu")
    got = ig.inflate_v10(v9, torch.from_numpy(mp.plan.stored_pos),
                         torch.from_numpy(mp.plan.stored_val), n_seg)
    assert got.dtype == torch.int32 and got.numel() == n_seg * v3.SEG_BYTES
    assert np.array_equal(got.numpy(), _np(want))
    out = got[: mp.plan.out_size].to(torch.uint8).numpy()
    for s, off, size in zip(streams, mp.out_offsets, mp.out_sizes):
        assert out[off : off + size].tobytes() == zlib.decompress(s, -15)


def test_inflate_v10_batch_against_zlib():
    """A merged batch with an empty stream, RLE chains, stored blocks."""
    streams = _merged_cases()["with_empty"] + [STREAMS["dense"]()]
    mp, n_seg = _v10_inputs(streams)
    body = ig.inflate_v10(hf.build_v9_arrays(mp, n_seg, device="cpu"),
                          torch.from_numpy(mp.plan.stored_pos),
                          torch.from_numpy(mp.plan.stored_val), n_seg)
    out = body[: mp.plan.out_size].to(torch.uint8).numpy()
    for s, off, size in zip(streams, mp.out_offsets, mp.out_sizes):
        assert out[off : off + size].tobytes() == zlib.decompress(s, -15)


def test_tail0_and_body_init():
    """An incoming window and an initial body (the split-stream shapes)
    through both packages' segmented resolvers."""
    stream = deflate(words(3000, seed=8), 6)
    mp = ref_merged.build_merged_plan([stream], records=True)
    v9 = ref_hf.build_piece_arrays(mp.recs, 1)
    rng = np.random.default_rng(3)
    tail0 = rng.integers(0, 256, (ref_lz.WINDOW // 128, 128)).astype(np.int32)
    body_init = rng.integers(0, 256, v3.SEG_BYTES).astype(np.int32)
    sp, sv = mp.plan.stored_pos, mp.plan.stored_val
    want = ref_ig.resolve_groups_segmented_v10(
        v9, 1, jnp.asarray(sp), jnp.asarray(sv), interpret=True,
        tail0=jnp.asarray(tail0), body_init=jnp.asarray(body_init))
    t = {k: torch.from_numpy(_np(v).copy()) for k, v in v9.items()}
    got = ig.resolve_groups_segmented_v10(
        t, 1, torch.from_numpy(sp), torch.from_numpy(sv),
        tail0=torch.from_numpy(tail0), body_init=torch.from_numpy(body_init))
    assert np.array_equal(got.numpy(), _np(want))
    n = mp.plan.out_size
    assert got[:n].to(torch.uint8).numpy().tobytes() == zlib.decompress(stream, -15)
    assert np.array_equal(got[n:].numpy(), body_init[n:])
