"""The three LZ77 resolvers of the PyTorch port (ops.lz77) against the JAX
package's Pallas kernels in interpret mode, at the wrappers' boundaries:
the same ``out_init`` and the same tapes or lists go to both, and the whole
returned buffer (pad row, window, body, slack) must be equal, bit for bit.

Bodies are cut into small segments so that a few KB of output already
cross segment edges: a non-zero window tail, matches that begin before the
body (head clip) or run past its end (tail clip), and sources inside a
stored block.  On the CPU the port's wrappers run their plain versions;
the card's branch of the segment resolvers is taken on CPU tensors with
the launches and every host read recorded.
"""

import ctypes
import functools
import zlib

import jax
import numpy as np
import pytest
import torch

from debigulator_tpu.ops import lz77_pallas as lz
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops import lz77 as tlz
from debigulator_tpu_torch.ops import phase_a as tpa
from debigulator_tpu_torch.ops import plan as tp
from debigulator_tpu_torch.ops.archive import lz77_generations as tlg
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
from torch_group_cases import MATCH_LISTS, match_list, serial_matches
from torch_stream_cases import STREAMS

SEG = 4096  # body bytes of one test segment
WIN_ROWS = lz.WINDOW // 128
CASES = ["dynamic", "mixed", "rle", "far", "stored"]


def test_constants_match_the_reference():
    for name in ("WINDOW", "PAD", "MAXLEN", "OUT_CAP", "TOK_MATCH_BIT"):
        assert getattr(tlz, name) == getattr(lz, name), name


@functools.lru_cache(maxsize=None)
def _phase_a(name):
    """The port's Phase A outputs (both tape forms) for a stream, numpy."""
    stream = STREAMS[name]()
    blocks, lengths, cells = scan_stream_cells(stream, tp.CELL_BITS)
    plan = tp.build_plan_v3(stream, blocks, lengths, cells=cells)
    inp = tpa.stage_phase_a_inputs(tpa.build_phase_a_inputs(plan),
                                   torch.device("cpu"))
    tape, counts = tpa.phase_a_tape(inp, plan.slots)
    ops = tpa.phase_a(inp, plan.slots)
    return (plan, inp.bob_cell.numpy(), tape.numpy(), counts.numpy(),
            [t.numpy() for t in ops], zlib.decompress(stream, -15))


def _body_with_stored(plan, n_seg):
    body = np.zeros(n_seg * SEG, np.int32)
    body[plan.stored_pos] = plan.stored_val
    return body.reshape(n_seg, SEG // 128, 128)


def _rows(a, pad_rows=0):
    return np.pad(a.reshape(-1, 128), ((0, pad_rows), (0, 0)))


def _scan_segments(ref_fn, port_fn, plan, cbase, cell_end):
    """Run both resolvers segment by segment, the reference's window tail
    carried to both; returns the joined body."""
    n_seg = -(-plan.out_size // SEG)
    bodies = _body_with_stored(plan, n_seg)
    offs = np.arange(n_seg) * SEG
    lo = np.searchsorted(cell_end, offs, side="right")
    hi = np.searchsorted(cbase, offs + SEG, side="left")
    pad = np.zeros((lz.PAD // 128, 128), np.int32)
    slack = np.zeros((4, 128), np.int32)
    tail = np.zeros((WIN_ROWS, 128), np.int32)
    out = []
    for s in range(n_seg):
        init = np.concatenate([pad, tail, bodies[s], slack])
        want = np.asarray(ref_fn(init, int(lo[s]), int(hi[s]), int(offs[s])))
        got = port_fn(torch.from_numpy(init.copy()), int(lo[s]), int(hi[s]),
                      int(offs[s]))
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), f"segment {s}"
        assert np.array_equal(init[: 1 + WIN_ROWS], want[: 1 + WIN_ROWS])
        tail = want[-4 - WIN_ROWS : -4]
        out.append(want[1 + WIN_ROWS : -4].reshape(-1))
    return np.concatenate(out)[: plan.out_size].astype(np.uint8).tobytes()


@pytest.mark.parametrize("name", CASES)
def test_resolve_tape_v6_segments(name):
    plan, bob, tape, counts, _, data = _phase_a(name)
    slots = plan.slots
    sv6 = next(s for s in (16, 32, 64, 128) if s >= slots)
    tape = np.pad(tape, ((0, 0), (0, sv6 - slots)), constant_values=-1)
    is_m = tape >= lz.TOK_MATCH_BIT
    out_len = np.where(is_m, (tape >> 16) & 0x3FFF, tape >= 0)
    cell_len = out_len.sum(1)
    cbase = (bob + np.cumsum(cell_len) - cell_len).astype(np.int32)
    # The reference's chunked DMA windows need a chunk of padding cells.
    chunk = max(128, lz.V6_MLIST_CAP // sv6)
    pad_c = (-(-len(counts) // chunk) + 1) * chunk - len(counts)
    tape2d = np.pad(tape, ((0, pad_c), (0, 0))).reshape(-1, 128)
    counts2d = np.pad(counts, (0, pad_c)).reshape(-1, 128)
    cbase2d = np.pad(cbase, (0, pad_c)).reshape(-1, 128)

    @jax.jit
    def ref(init, lo, hi, off):
        return lz.resolve_tape_v6(init, tape2d, counts2d, cbase2d, lo, hi,
                                  off, sv6, interpret=True)

    t = [torch.from_numpy(a) for a in (tape2d, counts2d, cbase2d)]

    def port(init, lo, hi, off):
        return tlz.resolve_tape_v6(init, *t, lo, hi, off, sv6)

    assert _scan_segments(ref, port, plan, cbase, cbase + cell_len) == data


@pytest.mark.parametrize("name", CASES)
def test_resolve_ops_v13_segments(name):
    plan, bob, _, _, (ma, mb, ra, rb, lit, cnt, outlen), data = _phase_a(name)
    slots = plan.slots
    cbase = (bob + np.cumsum(outlen) - outlen).astype(np.int32)
    chunk = max(128, lz.V13_MLIST_CAP // slots)
    pad_rows = chunk // (128 // slots)
    tapes = [_rows(np.ascontiguousarray(t.T), pad_rows)
             for t in (ma, mb, ra, rb, lit)]
    cnt2d = np.pad(cnt, (0, chunk)).reshape(-1, 128)
    cbase2d = np.pad(cbase, (0, chunk)).reshape(-1, 128)

    @jax.jit
    def ref(init, lo, hi, off):
        return lz.resolve_ops_v13(init, *tapes, cnt2d, cbase2d, lo, hi, off,
                                  slots, interpret=True)

    t = [torch.from_numpy(a) for a in (*tapes, cnt2d, cbase2d)]

    def port(init, lo, hi, off):
        return tlz.resolve_ops_v13(init, *t, lo, hi, off, slots)

    assert _scan_segments(ref, port, plan, cbase, cbase + outlen) == data


def test_segments_really_clip():
    """The small segments do exercise the clips: some match begins before
    its segment's body and some match runs past its end."""
    plan, bob, tape, _, _, _ = _phase_a("rle")
    is_m = tape >= lz.TOK_MATCH_BIT
    mlen = np.where(is_m, (tape >> 16) & 0x3FFF, 0)
    out_len = np.where(is_m, mlen, tape >= 0)
    cell_len = out_len.sum(1)
    start = (bob + np.cumsum(cell_len) - cell_len)[:, None] \
        + np.cumsum(out_len, 1) - out_len
    crossing = is_m & (start // SEG != (start + mlen - 1) // SEG)
    assert crossing.any()


def _match_list(name):
    """out_init with literals and stored bytes placed, and the compacted
    match list, as the reference's resolve_tape_fused prepares them."""
    plan, bob, tape, _, _, data = _phase_a(name)
    flat = tape.reshape(-1)
    is_m = flat >= lz.TOK_MATCH_BIT
    mlen = (flat >> 16) & 0x3FFF
    out_len = np.where(is_m, mlen, flat >= 0)
    base = np.repeat(bob, tape.shape[1])
    pos = base + np.cumsum(out_len) - out_len + lz.PAD + lz.WINDOW
    out_rows = -(-(plan.out_size + lz.PAD + lz.WINDOW + lz.MAXLEN + 512) // 128)
    out = np.zeros(out_rows * 128, np.int32)
    lit = (flat >= 0) & ~is_m
    out[pos[lit]] = flat[lit]
    out[plan.stored_pos + lz.PAD + lz.WINDOW] = plan.stored_val
    m_rows = 16 * -(-(int(is_m.sum()) + 300) // (16 * 128))
    mpos = np.full(m_rows * 128, lz.PAD + lz.WINDOW, np.int32)
    mmeta = np.zeros(m_rows * 128, np.int32)
    n = int(is_m.sum())
    mpos[:n] = pos[is_m]
    mmeta[:n] = (mlen[is_m] << 16) | (flat[is_m] & 0xFFFF)
    return plan, data, out.reshape(-1, 128), mpos.reshape(-1, 128), \
        mmeta.reshape(-1, 128), n


@functools.partial(jax.jit)
def _ref_v4(out2d, mpos, mmeta, n):
    return lz.resolve_matches_v4(out2d, mpos, mmeta, n_matches=n,
                                 interpret=True)


@pytest.mark.parametrize("name", CASES)
def test_resolve_matches_v4(name):
    plan, data, out2d, mpos, mmeta, n = _match_list(name)
    assert n < mpos.size  # n_matches short of the capacity
    want = np.asarray(_ref_v4(out2d, mpos, mmeta, n))
    got = tlz.resolve_matches_v4(*(torch.from_numpy(a.copy())
                                   for a in (out2d, mpos, mmeta)), n)
    assert np.array_equal(got.numpy(), want)
    start = lz.PAD + lz.WINDOW
    assert want.reshape(-1)[start : start + plan.out_size].astype(
        np.uint8).tobytes() == data


def test_resolve_matches_v4_bounded_by_n_matches():
    """Entries from n_matches on, and entries of length 0, do nothing.
    (The reference walks whole groups of 8, so it is held to that only at
    a multiple of 8; the port stops at n_matches exactly.)"""
    _, _, out2d, mpos, mmeta, n = _match_list("dynamic")
    mmeta = mmeta.copy()
    mmeta.reshape(-1)[3] &= 0xFFFF  # length 0 in the middle of the list
    half = n // 2 // 8 * 8
    want = np.asarray(_ref_v4(out2d, mpos, mmeta, half))
    got = tlz.resolve_matches_v4(*(torch.from_numpy(a.copy())
                                   for a in (out2d, mpos, mmeta)), half)
    assert np.array_equal(got.numpy(), want)
    full = np.asarray(_ref_v4(out2d, mpos, mmeta, n))
    assert not np.array_equal(full, want)
    t = [torch.from_numpy(a.copy()) for a in (out2d, mpos, mmeta)]
    odd = tlz.resolve_matches_v4(*t, half + 3)
    step = t[0].clone()
    for k in range(half + 3):  # one match at a time gives the same
        lst = [a.reshape(-1)[k : k + 1].repeat(1024).view(8, 128)
               for a in t[1:]]
        step = tlz.resolve_matches_v4(step, *lst, 1)
    assert torch.equal(odd, step)


def test_resolve_matches_v4_window_sources_and_overlap():
    """A hand-made list on a random buffer: sources in the window tail, a
    dist 1 run, period 3, the full length 258, a match reading the one
    before it, with the default n_matches (the capacity)."""
    rng = np.random.default_rng(0)
    out2d = rng.integers(0, 256, (1 + WIN_ROWS + 40, 128)).astype(np.int32)
    s = lz.PAD + lz.WINDOW
    recs = [(s, 258, 32768), (s + 258, 100, 1), (s + 358, 200, 3),
            (s + 600, 258, 258), (s + 858, 40, 20), (s + 900, 3, 30000),
            (s + 1000, 258, 142), (s + 1300, 77, 300)]
    mpos = np.full(8 * 128, s, np.int32)
    mmeta = np.zeros(8 * 128, np.int32)
    for i, (p, ln, d) in enumerate(recs):
        mpos[i], mmeta[i] = p, (ln << 16) | d
    mpos, mmeta = mpos.reshape(8, 128), mmeta.reshape(8, 128)
    want = np.asarray(jax.jit(lambda o, p, m: lz.resolve_matches_v4(
        o, p, m, interpret=True))(out2d, mpos, mmeta))
    got = tlz.resolve_matches_v4(*(torch.from_numpy(a.copy())
                                   for a in (out2d, mpos, mmeta)))
    assert np.array_equal(got.numpy(), want)
    flat = want.reshape(-1)
    assert np.array_equal(flat[s : s + 258], out2d.reshape(-1)[s - 32768 : s - 32510])
    assert (flat[s + 258 : s + 358] == flat[s + 257]).all()


@pytest.mark.parametrize("name", list(MATCH_LISTS))
def test_resolve_matches_v4_on_lists_that_rewrite_bytes(name):
    """Row 8 on hand-made lists that DEFLATE never makes (numpy seed 0, a
    random buffer: its pad row and window, then 40 rows): a reader between
    two writers of its source, a write after a read, a byte written by
    three matches, entries of distance 0 and length 0, a 258-long
    overlapping run, and n_matches = 8 short of the list.  The JAX kernel
    is strictly in order (its output is the serial walk's), and the port
    gives its bytes.  The first two lists failed on the parent tree, whose
    plain twin followed pointers by doubling (fault C4): body bytes
    2010..2019 and 1000..1019 differed."""
    buf, pos, meta, n = match_list(name, lz.PAD + lz.WINDOW,
                                   lz.PAD + lz.WINDOW)
    assert n % 8 == 0 or n == len(MATCH_LISTS[name][0])
    want = np.asarray(_ref_v4(buf, pos, meta, n))
    assert np.array_equal(want, serial_matches(buf, pos, meta, n))
    got = tlz.resolve_matches_v4(*(torch.from_numpy(a.copy())
                                   for a in (buf, pos, meta)), n)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, buf)


def test_wrappers_reject_what_the_kernels_do_not_take():
    out = torch.zeros((300, 128), dtype=torch.int32)
    lst = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        tlz.resolve_matches_v4(out.long(), lst, lst)
    with pytest.raises(ValueError):
        tlz.resolve_matches_v4(out, lst, lst[:4])
    with pytest.raises(ValueError):
        tlz.resolve_tape_v6(out, lst, lst[:1], lst[:1], 0, 128, 0, 12)
    with pytest.raises(ValueError):
        tlz.resolve_tape_v6(out, lst, lst[:1], lst[:2], 0, 128, 0, 8)
    with pytest.raises(ValueError):
        tlz.resolve_ops_v13(out, lst[:4], lst, lst, lst, lst, lst[:1],
                            lst[:1], 0, 128, 0, 8)


# ---------------------------------------------------------------------------
# The card's branch of the segment resolvers, taken on CPU tensors with the
# launches recorded instead of made
# ---------------------------------------------------------------------------

#: Host reads of a device tensor; any of them between two launches would
#: stall the card's stream.
READ_BACKS = [(torch.Tensor, n) for n in ("item", "tolist", "cpu", "numpy",
                                         "__int__", "__index__", "__bool__",
                                         "__float__", "nonzero")] + \
    [(torch, "nonzero")]


def _card_call(name, cells: int, lo: int, hi: int):
    """(wrapper, thunk) for a call of one segment resolver on small CPU
    inputs: 16 slots a cell, every cell of one literal and one match, a
    buffer whose pad row, slack rows and tape padding hold -1."""
    slots = 16
    rng = np.random.default_rng(1)
    body = 4096
    init = rng.integers(0, 256, tlz.BODY_START + body + 4 * 128).astype(
        np.int32)
    init[: tlz.PAD] = init[tlz.BODY_START + body :] = -1
    init = torch.from_numpy(init).view(-1, 128)
    pos = torch.from_numpy((np.arange(cells) * 8).astype(np.int32))
    cnt = torch.full((cells,), 2, dtype=torch.int32)
    if name == "resolve_tape_v6":
        tape = torch.full((cells, slots), -1, dtype=torch.int32)
        tape[:, 0] = 65
        tape[:, 1] = tlz.TOK_MATCH_BIT | (7 << 16) | 1
        return tlz.resolve_tape_v6, lambda: tlz.resolve_tape_v6(
            init, tape.view(-1, 128), cnt.view(-1, 128), pos.view(-1, 128),
            lo, hi, 0, slots)
    if name == "resolve_ops_v13":
        one = torch.zeros((cells, slots), dtype=torch.int32)
        ma, mb, ra, rb, lit = (one.clone() for _ in range(5))
        ma[:, 0] = 1
        mb[:, 0] = (7 << 16) | 1
        rb[:, 0] = 1
        lit[:, 0] = 66
        packed = torch.full((cells,), (1 << 16) | (1 << 8) | 1,
                            dtype=torch.int32)
        return tlz.resolve_ops_v13, lambda: tlz.resolve_ops_v13(
            init, *(t.view(-1, 128) for t in (ma, mb, ra, rb, lit)),
            packed.view(-1, 128), pos.view(-1, 128), lo, hi, 0, slots)
    tape = torch.full((hi - lo, slots), -1, dtype=torch.int32)
    tape[:, 0] = 67
    tape[:, 1] = tlz.TOK_MATCH_BIT | (7 << 16) | 1
    counts = torch.full((hi - lo,), 2, dtype=torch.int32)
    return tlg.resolve_tape_v1, lambda: tlg.resolve_tape_v1(
        tape, counts, 8 * (hi - lo))


CARD_ENTRIES = {
    "resolve_tape_v6": ["dbg_lz77_tape_place", "dbg_lz77_tape_chase"],
    "resolve_ops_v13": ["dbg_lz77_ops_place", "dbg_lz77_ops_chase"],
    "resolve_tape_v1": ["dbg_lz77_tape_v1_len", "dbg_lz77_tape_place",
                        "dbg_lz77_tape_chase"],
}


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("name", list(CARD_ENTRIES))
def test_segment_resolvers_card_branch(monkeypatch, name, empty):
    """On the card each resolver is its launches and nothing read back
    between them: the entries in order, each with its declared argument
    count and types, the chase fed the placement's lists and scratch of one
    pointer and one bit per body byte, the count moved by one.  An empty
    range of cells launches nothing and leaves the count."""
    cells = 256
    lo, hi = (40, 40) if empty else (3, 200)
    fn, call = _card_call(name, cells, lo, hi)
    events = []

    def record(entry, *a):
        events.append(("launch", entry, a))
        if entry == "dbg_lz77_tape_v1_len":  # the lengths the kernel gives
            a[4].copy_(tlg._cell_lengths_plain(a[0], a[1]).to(torch.int32))

    def reader(owner, attr):
        real = getattr(owner, attr)

        def read(*a, **k):
            events.append(("read", attr, None))
            return real(*a, **k)
        return read

    for owner, attr in READ_BACKS:
        monkeypatch.setattr(owner, attr, reader(owner, attr))
    for mod in (tlz, tlg):
        monkeypatch.setattr(mod, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch", record)
    before = fn.launches
    call()
    monkeypatch.undo()
    launched = [i for i, e in enumerate(events) if e[0] == "launch"]
    if empty:
        assert not launched and fn.launches == before
        return
    assert fn.launches == before + 1
    assert [events[i][1] for i in launched] == CARD_ENTRIES[name]
    assert all(e[0] == "launch" for e in events[launched[0] : launched[-1]])
    if name != "resolve_tape_v1":  # v1 checks its total after the launches
        assert not any(e[0] == "read" for e in events)
    for i in launched:
        _, entry, args = events[i]
        argtypes = _kernels._ENTRIES[entry][1]
        assert len(args) == len(argtypes), entry
        for a, at in zip(args, argtypes, strict=True):
            assert isinstance(a, torch.Tensor) if at is ctypes.c_void_p \
                else type(a) is int, entry
    place, chase = (events[i][2] for i in launched[-2:])
    out, body_end, mpos, mmeta, kinc, n, slots, state, bits = chase
    assert out is place[0] and body_end == place[1]
    assert [(t.data_ptr(), t.shape) for t in (mpos, mmeta)] == \
        [(t.data_ptr(), t.shape) for t in place[-3:-1]]
    assert n == hi - lo == kinc.numel() and mpos.numel() == n * slots
    assert torch.equal(kinc, torch.cumsum(place[-1], 0, dtype=torch.int32))
    assert state.dtype == torch.int64
    assert state.numel() == body_end - tlz.BODY_START
    assert bits.numel() == -(-state.numel() // 32)
