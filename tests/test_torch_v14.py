"""The v14 driver of the PyTorch port (compact_v14, the glue of
resolve_segmented_v14, resolve_walk_v14 and inflate_v14) against the JAX
package (Pallas in interpret mode), the port's v13 driver and zlib, on
device="cpu" (the kernels' plain versions).  Bit-exact everywhere."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debigulator_tpu.ops import inflate_v3 as v3
from debigulator_tpu.ops import lz77_pallas as ref_lz
from debigulator_tpu.ops.archive import inflate_generations as ref_ig
from debigulator_tpu.ops.archive import lz77_generations as ref_lzgen
from debigulator_tpu.ops.phase_a_pallas import build_pa_arrays
from debigulator_tpu.ops.scanner import scan_stream_cells as ref_scan
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import phase_a as tpa
from debigulator_tpu_torch.ops import plan as tp
from debigulator_tpu_torch.ops.archive import inflate_generations as ig
from debigulator_tpu_torch.ops.archive import lz77_generations as lzgen
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
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


CPU = torch.device("cpu")


def _plan(stream):
    blocks, lengths, cells = scan_stream_cells(stream, tp.CELL_BITS)
    plan = tp.build_plan_v3(stream, blocks, lengths, cells=cells)
    pa = tpa.stage_phase_a_inputs(tpa.build_phase_a_inputs(plan), CPU)
    return plan, pa, tp.plan_arrays_v7(plan, CPU)


def _spy(monkeypatch, module, name, store):
    real = getattr(module, name)

    def spy(*a, **k):
        out = real(*a, **k)
        store[name] = (a, k, out)
        return out

    monkeypatch.setattr(module, name, spy)


def _port_v14(monkeypatch, stream):
    """The port's Phase B of v14 on a stream, with the arguments and
    results of compact_v14, segment_lims and resolve_walk_v14 kept."""
    plan, pa, arrays = _plan(stream)
    seen = {}
    _spy(monkeypatch, lzgen, "compact_v14", seen)
    _spy(monkeypatch, lzgen, "resolve_walk_v14", seen)
    _spy(monkeypatch, ig, "segment_lims", seen)
    tapes = tpa.phase_a(pa, plan.slots)
    n_seg = inf.n_segments(plan.out_size)
    body = ig.resolve_segmented_v14(*tapes, pa.bob_cell, n_seg,
                                    arrays["stored_pos"],
                                    arrays["stored_val"], plan.slots)
    monkeypatch.undo()
    return plan, pa, tapes, n_seg, body, seen


def _concrete(x):
    return not isinstance(x, jax.core.Tracer)


@pytest.mark.parametrize("name", ["dynamic", "mixed", "rle"])
def test_compact_v14(monkeypatch, name):
    """All five outputs, padding included, on the port's own glue inputs."""
    stream = STREAMS[name]()
    plan, *_, seen = _port_v14(monkeypatch, stream)
    args = seen["compact_v14"][0]
    got = seen["compact_v14"][2]
    want = ref_lzgen.compact_v14(*(jnp.asarray(a.numpy()) for a in args[:9]),
                                 *args[9:], interpret=True)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["dynamic", "far"])
def test_resolve_segmented_v14_glue(monkeypatch, name):
    """The glue against the reference's on the same Phase A tapes: compact
    inputs, the dense lists with the clean bits, and the body."""
    stream = STREAMS[name]()
    plan, pa, tapes, n_seg, body, seen = _port_v14(monkeypatch, stream)
    ref = {}

    real_compact, real_walk = ref_lzgen.compact_v14, ref_lzgen.resolve_walk_v14

    def spy_compact(*a, **k):
        ref["compact"] = a
        return real_compact(*a, **k)

    def spy_walk(out_init, lims, *lists, **k):
        # Called inside lax.scan: the dense lists are closed-over arrays.
        ref["walk"] = [np.asarray(x) for x in lists[:5] if _concrete(x)]
        return real_walk(out_init, lims, *lists, **k)

    monkeypatch.setattr(ref_lzgen, "compact_v14", spy_compact)
    monkeypatch.setattr(ref_lzgen, "resolve_walk_v14", spy_walk)
    want = ref_ig.resolve_segmented_v14(
        *(jnp.asarray(t.numpy()) for t in tapes),
        jnp.asarray(pa.bob_cell.numpy()), n_seg,
        jnp.asarray(plan.stored_pos), jnp.asarray(plan.stored_val),
        plan.slots, interpret=True)
    monkeypatch.undo()
    for g, w in zip(seen["compact_v14"][0][:9], ref["compact"][:9],
                    strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))
    walk_args = seen["resolve_walk_v14"][0]
    got_lists = [t.numpy() for t in walk_args[2:7]]
    assert len(ref["walk"]) == 5
    for g, w in zip(got_lists[:4], ref["walk"][:4], strict=True):
        assert np.array_equal(g, w)
    rows = got_lists[4].shape[0]  # litD: the reference pads a VMEM window
    assert np.array_equal(got_lists[4], ref["walk"][4][:rows])
    assert not ref["walk"][4][rows:].any()
    assert np.array_equal(body.numpy(), np.asarray(want))
    assert body[: plan.out_size].to(torch.uint8).numpy().tobytes() == \
        zlib.decompress(stream, -15)


@pytest.mark.parametrize("seg", [0, 2])
def test_resolve_walk_v14_segment(monkeypatch, seg):
    """One 8 KiB segment cut from a body (its window the bytes before it,
    matches clipped at its head and end) through both walk kernels."""
    stream = deflate(words(6000, seed=12) + bytes(range(256)) * 8, 6)
    data = np.frombuffer(zlib.decompress(stream, -15), np.uint8)
    *_, seen = _port_v14(monkeypatch, stream)
    _, _, mdst, mmeta, rdst, rmeta, lit_d = seen["resolve_walk_v14"][0]
    slots = seen["compact_v14"][0][-1]
    seg_bytes = 8192
    lims = ig.segment_lims(*seen["segment_lims"][0][:6],
                           -(-len(data) // seg_bytes), seg_bytes=seg_bytes)[seg]
    w = ref_lz.WINDOW
    off = seg * seg_bytes
    init = np.zeros(ref_lz.PAD + w + seg_bytes + 512, np.int32)
    tail = data[max(0, off - w) : off].astype(np.int32)
    init[ref_lz.PAD + w - len(tail) : ref_lz.PAD + w] = tail
    init = torch.from_numpy(init.reshape(-1, 128))
    got = lzgen.resolve_walk_v14(init, lims, mdst, mmeta, rdst, rmeta, lit_d)
    lit_ref = np.zeros((lit_d.shape[0] + ref_lzgen.V14_LIT_ROWS, 128),
                       np.int32)
    lit_ref[: lit_d.shape[0]] = lit_d.numpy()
    want = ref_lzgen.resolve_walk_v14(
        jnp.asarray(init.numpy()), jnp.asarray(lims.numpy()),
        *(jnp.asarray(t.numpy()) for t in (mdst, mmeta, rdst, rmeta)),
        jnp.asarray(lit_ref), slots, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    body = got.view(-1)[lzgen.BODY_START : lzgen.BODY_START + seg_bytes]
    n = min(seg_bytes, len(data) - off)
    assert np.array_equal(body[:n].numpy(), data[off : off + n])


def _segment_text():
    return words(6000, seed=12) + bytes(range(256)) * 8


#: name -> (data, first segment, segments in the call, odd buffer); 8 KiB
#: segments.
WALK_V14_CASES = {
    "zero_run": (lambda: bytes(24_576), 0, 3, False),
    "copies_of_copies": (lambda: nested_copies(24_576), 0, 3, False),
    "segments": (_segment_text, 1, 3, False),
    "odd_init": (_segment_text, 2, 2, True),
}


@pytest.mark.parametrize("name", list(WALK_V14_CASES))
def test_resolve_walk_v14_chase_cases(monkeypatch, name):
    """What the card's chase changes against the in-order kernel: a zero
    run of dist-1 matches (chains one hop per 258 bytes), copies of
    copies, several segments in one call (sources in the segment before,
    a match head-clipped at the body start), and a buffer with -1 in its
    pad row, bodies and slack and values above 255 in its window.  The
    port's one call over the segments against the JAX kernel in interpret
    mode, one call a segment with the window carried; bit-exact, and equal
    to the data where the window is the data."""
    make, k0, n, odd = WALK_V14_CASES[name]
    data = make()
    flat = np.frombuffer(data, np.uint8)
    *_, seen = _port_v14(monkeypatch, deflate(data, 9))
    _, _, mdst, mmeta, rdst, rmeta, lit_d = seen["resolve_walk_v14"][0]
    slots = seen["compact_v14"][0][-1]
    seg = 8192
    lims = ig.segment_lims(*seen["segment_lims"][0][:6], -(-len(flat) // seg),
                           seg_bytes=seg)
    call = lims[k0 : k0 + n].contiguous()
    # A call from the middle of the stream holds a match that begins
    # before its body (head-clipped); one from the start holds none.
    at = slice(int(call[0, 0]), int(call[-1, 1]))
    pos = mdst.view(-1)[at].long() - int(call[0, 4])
    end = pos + ((mmeta.view(-1)[at].long() >> 16) & 0x1FF)
    assert bool(((pos < 0) & (end > 0)).any()) == (k0 > 0)
    init = segments_init(flat, k0, n, seg, odd)
    lit_ref = np.zeros((lit_d.shape[0] + ref_lzgen.V14_LIT_ROWS, 128),
                       np.int32)
    lit_ref[: lit_d.shape[0]] = lit_d.numpy()
    lists = [jnp.asarray(t.numpy()) for t in (mdst, mmeta, rdst, rmeta)]
    rows = lims.numpy()

    def ref_call(buf, i):
        return ref_lzgen.resolve_walk_v14(
            jnp.asarray(buf), jnp.asarray(rows[k0 + i]), *lists,
            jnp.asarray(lit_ref), slots, interpret=True)

    want = by_segment(ref_call, init, n, seg)
    got = lzgen.resolve_walk_v14(torch.from_numpy(init), call, mdst, mmeta,
                                 rdst, rmeta, lit_d)
    assert np.array_equal(got.numpy(), want)
    if not odd:
        off = k0 * seg
        m = min(n * seg, len(flat) - off)
        body = got.view(-1)[lzgen.BODY_START : lzgen.BODY_START + m]
        assert np.array_equal(body.numpy(), flat[off : off + m])


@pytest.mark.parametrize("name", list(WALK_V14_CASES))
def test_walk_v14_card_branch_model_matches_the_plain_twin(monkeypatch,
                                                           name):
    """Row 10c's card branch on CPU tensors, its two C entries run by the
    model of the kernels (torch_group_cases.emulate: the runs, then the
    group chase under walk_v14's record source, clean groups included) on
    the calls of WALK_V14_CASES: the plain twin's bytes, one launch
    counted, each entry given as many arguments as its C entry takes and
    the chase its scratch for every buffer byte and every match."""
    from debigulator_tpu_torch.ops import _kernels
    from torch_group_cases import emulate

    make, k0, n, odd = WALK_V14_CASES[name]
    flat = np.frombuffer(make(), np.uint8)
    *_, seen = _port_v14(monkeypatch, deflate(flat.tobytes(), 9))
    _, _, mdst, mmeta, rdst, rmeta, lit_d = seen["resolve_walk_v14"][0]
    assert bool((mmeta < 0).any())  # clean groups
    seg = 8192
    lims = ig.segment_lims(*seen["segment_lims"][0][:6], -(-len(flat) // seg),
                           seg_bytes=seg)[k0 : k0 + n].contiguous()
    init = torch.from_numpy(segments_init(flat, k0, n, seg, odd))
    args = (init, lims, mdst, mmeta, rdst, rmeta, lit_d)
    want = lzgen.resolve_walk_v14(*args)
    made = []
    monkeypatch.setattr(lzgen, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch", emulate(made))
    before = lzgen.resolve_walk_v14.launches
    got = lzgen.resolve_walk_v14(*args)
    monkeypatch.undo()
    assert torch.equal(got, want)
    assert lzgen.resolve_walk_v14.launches == before + 1
    assert [e for e, _ in made] == ["dbg_walk_v14_runs", "dbg_walk_v14_chase"]
    for entry, a in made:
        assert len(a) == len(_kernels._ENTRIES[entry][1])
    chase = made[-1][1]
    assert chase[1] == init.numel() and chase[5] == n
    assert chase[9] - chase[8] == int(lims[-1, 1] - lims[0, 0])


def test_inflate_v14_against_the_jit():
    """The whole driver against _inflate_v14_jit on a few KB."""
    data = (b"experiment " * 300 + b"\x00" * 1500
            + bytes(np.random.default_rng(9).integers(0, 256, 1000,
                                                      dtype=np.uint8)))
    stream = deflate(data)
    blocks, lengths, cells = ref_scan(stream, v3.CELL_BITS)
    ref_plan = v3.build_plan_v3(stream, blocks, lengths, cells=cells)
    n_seg = 1
    want, want_of = ref_ig._inflate_v14_jit(
        build_pa_arrays(ref_plan), v3.plan_arrays_v7(ref_plan),
        ref_plan.slots, n_seg, interpret=True)
    plan, pa, arrays = _plan(stream)
    got, overflow = ig.inflate_v14(pa, arrays, plan.slots, n_seg)
    assert not bool(overflow) and not bool(want_of)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[: len(data)].to(torch.uint8).numpy().tobytes() == data


@pytest.mark.parametrize("name", list(STREAMS))
def test_inflate_v14(name):
    """inflate_v14 against zlib and the port's v13 driver."""
    stream = STREAMS[name]()
    plan, pa, arrays = _plan(stream)
    n_seg = inf.n_segments(plan.out_size)
    got, overflow = ig.inflate_v14(pa, arrays, plan.slots, n_seg)
    v13, _ = inf.inflate_v13(pa, arrays, plan.slots, n_seg)
    assert not bool(overflow)
    assert torch.equal(got, v13)
    assert got[: plan.out_size].to(torch.uint8).numpy().tobytes() == \
        zlib.decompress(stream, -15)


def test_inflate_v14_flags_overflow_below_the_exact_slots():
    plan, pa, arrays = _plan(STREAMS["dense"]())
    assert plan.slots == 32
    assert bool(ig.inflate_v14(pa, arrays, 16, 1)[1])


def test_inflate_v14_multi_segment():
    """A body of two 512 KiB segments, matches across the edge."""
    data = words(150_000, seed=6)
    plan, pa, arrays = _plan(deflate(data, 9))
    body, overflow = ig.inflate_v14(pa, arrays, plan.slots, 2)
    assert not bool(overflow) and body.numel() == 2 * tp.SEG_BYTES
    assert body[: plan.out_size].to(torch.uint8).numpy().tobytes() == data


def _v14_edge_args(name: str):
    """compact_v14 arguments on 1,024 cells of 16 slots: a third of the
    cells empty and a third full ("empty_full"), every cell empty
    ("all_empty"), or as empty_full with every 37th count past `slots`
    ("overflow"; each list's offsets are the exclusive prefix sums of the
    raw counts, as resolve_segmented_v14 makes them).  Returns the port's
    arguments and the counts with overflows cut to `slots`."""
    rng = np.random.default_rng(21)
    cells, slots = 1024, 16
    kind = rng.integers(0, 3, (3, cells))
    counts = np.where(kind == 0, 0, np.where(kind == 1, slots,
                                             rng.integers(1, slots, (3, cells))))
    if name == "all_empty":
        counts[:] = 0
    if name == "overflow":
        counts[:, 3::37] = 40
    clipped = np.minimum(counts, slots)

    def rows(a):
        return torch.from_numpy(np.asarray(a, np.int32)).view(-1, 128)

    def packed(c):
        return rows((c[0] << 16) | (c[1] << 8) | c[2])

    nrows = cells * slots // 128 + 2 * lzgen.V14_STAGE_ROWS + 2
    args = ([rows(rng.integers(1, 1 << 31, cells * slots)) for _ in range(5)]
            + [packed(counts)] + [rows(np.cumsum(c) - c) for c in counts]
            + [nrows, cells * slots // 128 + 2, slots])
    return args, packed(clipped)


@pytest.mark.parametrize("name", ["empty_full", "all_empty", "overflow"])
def test_compact_v14_edge_cases_match_pallas(name):
    """Empty cells, full cells, no records at all, and overflowed counts
    (read as `slots`, the rest of their span left zero): the port against
    _compact_kernel_v14 in interpret mode given the counts cut to
    `slots` (the reference writes a count past `slots` from the
    neighbouring cells' slots, which every caller discards)."""
    args, clipped = _v14_edge_args(name)
    got = lzgen.compact_v14(*args)
    ref_args = [*args[:5], clipped, *args[6:9]]
    want = ref_lzgen.compact_v14(*(jnp.asarray(a.numpy()) for a in ref_args),
                                 *args[9:], interpret=True)
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["empty_full", "overflow"])
def test_compact_v14_card_branch_is_one_launch_and_no_zeros(monkeypatch,
                                                            name):
    """The card's branch of compact_v14 on CPU tensors with the launch
    recorded instead of made: one launch, outputs from torch.empty, no
    torch.zeros (the kernel writes every output slot)."""
    from debigulator_tpu_torch.ops import _kernels

    args, _ = _v14_edge_args(name)
    made = []

    def no_zeros(*a, **k):
        raise AssertionError("compact_v14 zero-filled its outputs")

    monkeypatch.setattr(lzgen, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch",
                        lambda entry, *a: made.append((entry, a)))
    monkeypatch.setattr(torch, "zeros", no_zeros)
    monkeypatch.setattr(torch.Tensor, "zero_", no_zeros)
    before = lzgen.compact_v14.launches
    out = lzgen.compact_v14(*args)
    monkeypatch.undo()
    assert lzgen.compact_v14.launches == before + 1
    assert [e for e, _ in made] == ["dbg_compact_v14"]
    launched = made[0][1]
    assert len(launched) == len(_kernels._ENTRIES["dbg_compact_v14"][1])
    assert [o.data_ptr() for o in out] == [
        launched[i].data_ptr() for i in (11, 12, 13, 14, 16)]
