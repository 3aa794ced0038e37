"""Phase B of the PyTorch port against the JAX package: the glue, size8,
the compact kernel's dense lists and the walk's decoded body (bit-exact,
tolerance 0).  JAX runs its Pallas kernels in interpret mode on the CPU;
the port runs its plain PyTorch versions on the CPU."""

import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debigulator_tpu.ops import inflate_v3 as v3
from debigulator_tpu.ops import phase_b_v15 as pb15
from debigulator_tpu.ops.phase_a_pallas import build_pa_arrays
from debigulator_tpu.ops.scanner import scan_stream_cells
from debigulator_tpu.parallel import merged as jm
from debigulator_tpu_torch.ops import phase_a as tpa
from debigulator_tpu_torch.ops import phase_b as tpb
from debigulator_tpu_torch.ops import plan as tp
from torch_stream_cases import ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


def _deflate(data, level=6):
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def _words(n, seed):
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"\n"]
    return b"".join(words[int(v) % 5] for v in rng.integers(0, 5, n))


def _mixed():
    """Text, an RLE run (dist < len records), random bytes and a stored
    block in one stream."""
    rng = np.random.default_rng(9)
    t = _words(3000, 1)
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    st = c.compress(t + b"\x00" * 4000) + c.flush(zlib.Z_FULL_FLUSH)
    c0 = zlib.compressobj(0, zlib.DEFLATED, -15)
    mid = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    st += c0.compress(mid) + c0.flush(zlib.Z_FULL_FLUSH)
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    st += c.compress(t[::-1]) + c.flush()
    return st, t + b"\x00" * 4000 + mid + t[::-1]


def _nested(blocks=300, width=64, seed=11):
    """Each block a copy of the one before with one byte changed: the
    later blocks' matches copy copies (chains ~one hop a block deep)."""
    rng = np.random.default_rng(seed)
    cur = bytearray(rng.integers(0, 256, width, dtype=np.uint8).tobytes())
    out = bytearray()
    for _ in range(blocks):
        out += cur
        cur[int(rng.integers(0, width))] = int(rng.integers(0, 256))
    return bytes(out)


def _merged_pair():
    """Two streams of one merged batch: text and a zero run."""
    datas = [_words(2500, 3), b"\x00" * 30_000 + _words(500, 4)]
    return [_deflate(datas[0]), _deflate(datas[1], 9)], datas


CASES = {
    "text": lambda: (_deflate(_words(6000, 2)), _words(6000, 2)),
    "rle": lambda: (_deflate(b"ab" * 3000 + b"z" * 9000, 9),
                    b"ab" * 3000 + b"z" * 9000),
    "mixed_stored": _mixed,
    # Deep chains for the walk's source chase: a zero run coded as one
    # literal and dist-1 matches (one hop per 258 bytes), and copies of
    # copies; then a merged batch, which the kernel resolves as one.
    "zero_run": lambda: (_deflate(b"\x00" * 120_000, 9), b"\x00" * 120_000),
    "nested": lambda: (_deflate(_nested(), 9), _nested()),
    "merged_pair": _merged_pair,
}


class _Case:
    """Plan, Phase A outputs (port, plain) and staged inputs of a stream."""

    def __init__(self, name):
        raw, data = CASES[name]()
        if isinstance(raw, list):  # a merged batch of streams
            mp = jm.build_merged_plan(raw, records=False)
            self.ref_plan, self.offsets, self.datas = \
                mp.plan, mp.out_offsets, data
        else:
            blocks, lengths, cells = scan_stream_cells(raw, v3.CELL_BITS)
            self.ref_plan = v3.build_plan_v3(raw, blocks, lengths,
                                             cells=cells)
            self.offsets, self.datas = [0], [data]
        self.plan = tp.plan_from_numpy(dataclasses.asdict(self.ref_plan))
        self.inp = tpa.stage_phase_a_inputs(
            tpa.build_phase_a_inputs(self.plan), torch.device("cpu"))
        self.slots = self.plan.slots
        self.a = tpa.phase_a(self.inp, self.slots)
        self.rec = tpb.prep_records(*self.a, self.inp.bob_cell, self.slots)


@functools.lru_cache(maxsize=None)
def case(name):
    return _Case(name)


@functools.partial(jax.jit, static_argnames=("slots", "dense_rows"))
def _ref_compact(dm, mm, dr, mr, mbase, rbase, slots, dense_rows):
    di = jnp.full((dense_rows, 128), pb15.BIG, jnp.int32)
    zi = jnp.zeros((dense_rows, 128), jnp.int32)
    return pb15.compact_v15(dm, mm, dr, mr, mbase, rbase, di, zi, di, zi,
                            slots, interpret=True)


_ref_resolve = jax.jit(
    pb15.resolve_segmented_v15,
    static_argnames=("n_seg", "slots", "seg_bytes", "interpret"))


def _ref_glue(c: _Case):
    """numpy transcription of resolve_segmented_v15's record prep
    (phase_b_v15.py:864-899)."""
    ma, mb, ra, rb, lit, cnt, outlen = (x.numpy().astype(np.int64) for x in c.a)
    slots, cells_pad = ma.shape
    cpr = 128 // slots
    mc, rc = (cnt >> 16) & 0xFF, (cnt >> 8) & 0xFF
    bob = c.inp.bob_cell.numpy().astype(np.int64)
    cbase = bob + np.cumsum(outlen) - outlen
    si = np.arange(slots)[:, None]
    vm, vr = si < mc[None], si < rc[None]
    ci = np.arange(cells_pad)[None]
    metar = np.where(vr, ((ci // cpr) << 14) | (((ci % cpr) * slots
                                                  + (rb >> 16)) << 7)
                     | (rb & 0xFFFF), 0)
    rows = {"dm": np.where(vm, ma + cbase, 0), "mm": np.where(vm, mb, 0),
            "dr": np.where(vr, ra + cbase, 0), "mr": metar, "lit": lit}
    out = {k: v.T.reshape(-1).astype(np.uint32).view(np.int32)
           for k, v in rows.items()}
    n_chunks = cells_pad // pb15.CHUNK_CELLS
    for key, cc in (("mbase", mc), ("rbase", rc)):
        r = -(-cc.reshape(n_chunks, -1).sum(1) // 128)
        out[key] = (np.cumsum(r) - r).astype(np.int32)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_glue_matches_reference(name):
    c = case(name)
    want = _ref_glue(c)
    for key, w in want.items():
        g = getattr(c.rec, key).numpy()
        assert g.dtype == np.int32 and np.array_equal(w, g), key


@pytest.mark.parametrize("name", sorted(CASES))
def test_compact_matches_pallas(name):
    c = case(name)
    slots = c.slots
    per_chunk = pb15.CHUNK_CELLS * slots
    dense_rows = (c.rec.dm.numel() // 128 + per_chunk // 128 + 2
                  + pb15.SUB_ROWS + 16)
    want = _ref_compact(*(jnp.asarray(getattr(c.rec, k).numpy()
                                      .reshape(-1, 128))
                          for k in ("dm", "mm", "dr", "mr")),
                        jnp.asarray(c.rec.mbase.numpy()),
                        jnp.asarray(c.rec.rbase.numpy()),
                        slots=slots, dense_rows=dense_rows)
    got = tpb.compact(c.rec, slots)
    for n, w, g in zip(("mdst", "mmeta", "rdst", "rmeta"), want, got,
                       strict=True):
        assert np.array_equal(np.asarray(w).reshape(-1), g.numpy()), n


def _edge_records(slots: int, counts: np.ndarray, dst_hi: np.ndarray,
                  seed: int) -> tpb.Records:
    """Records of cells with the given match counts (run counts rolled by
    one cell): valid slots hold random dst below dst_hi[cell] and a non-zero
    meta, the rest zeros; chunk row bases as prep_records lays them out."""
    rng = np.random.default_rng(seed)
    n_chunks = len(counts) // tpb.CHUNK_CELLS
    lists = []
    for cnt in (counts, np.roll(counts, 1)):
        valid = (np.arange(slots)[None, :] < cnt[:, None]).reshape(-1)
        hi = np.repeat(dst_hi.astype(np.int64), slots)
        d = np.where(valid, rng.integers(0, 1 << 62, valid.size) % hi, 0)
        m = np.where(valid, rng.integers(1, 1 << 31, valid.size), 0)
        rows = -(-cnt.reshape(n_chunks, -1).sum(1) // 128)
        lists += [torch.from_numpy(d.astype(np.int32)),
                  torch.from_numpy(m.astype(np.int32)),
                  torch.from_numpy((np.cumsum(rows) - rows).astype(np.int32))]
    dm, mm, mbase, dr, mr, rbase = lists
    return tpb.Records(dm, mm, dr, mr, mbase, rbase, None)


def _edge_case(name):
    """(slots, counts, dst_hi) of the look-back edge cases."""
    cells = tpb.CHUNK_CELLS
    rng = np.random.default_rng(len(name))
    if name == "all_empty":
        return 8, np.zeros(3 * cells, np.int64), np.ones(3 * cells)
    if name == "far_fill":
        # Chunk 0 holds the largest dst; of the next 11 chunks only chunk 6
        # holds records, all smaller: every later fill comes from chunk 0.
        counts = np.zeros(12 * cells, np.int64)
        counts[:cells] = rng.integers(0, 9, cells)
        counts[6 * cells : 6 * cells + 40] = 2
        hi = np.full(12 * cells, 1000)
        hi[:cells] = 1 << 29
        return 8, counts, hi
    if name == "all_valid":
        return 8, np.full(3 * cells, 8), np.full(3 * cells, 1 << 30)
    return 16, rng.integers(0, 17, cells), np.full(cells, 1 << 30)


EDGE_CASES = ["all_empty", "far_fill", "all_valid", "single_chunk"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_compact_edge_cases_match_pallas(name):
    """Inputs that stress the kernel's look-back, through the plain
    version against the reference's compact_v15 in interpret mode: every
    chunk empty, a fill carried across eleven chunks, every slot valid, a
    single chunk."""
    slots, counts, hi = _edge_case(name)
    rec = _edge_records(slots, counts, hi, seed=3)
    per_chunk = pb15.CHUNK_CELLS * slots
    dense_rows = (rec.dm.numel() // 128 + per_chunk // 128 + 2
                  + pb15.SUB_ROWS + 16)
    want = _ref_compact(*(jnp.asarray(getattr(rec, k).numpy().reshape(-1, 128))
                          for k in ("dm", "mm", "dr", "mr")),
                        jnp.asarray(rec.mbase.numpy()),
                        jnp.asarray(rec.rbase.numpy()),
                        slots=slots, dense_rows=dense_rows)
    got = tpb.compact(rec, slots)
    for n, w, g in zip(("mdst", "mmeta", "rdst", "rmeta"), want, got,
                       strict=True):
        assert np.array_equal(np.asarray(w).reshape(-1), g.numpy()), n


@pytest.mark.parametrize("name", EDGE_CASES)
def test_compact_card_branch_is_one_launch_and_no_fill(monkeypatch, name):
    """The card's branch of ``compact``, taken on CPU tensors with the
    launch recorded instead of made: one launch of dbg_compact with the
    arguments the C entry declares, and no fill of the outputs (the
    kernel writes every slot); the only tensor zeroed is the look-back
    status, two words a chunk and the ticket."""
    import ctypes

    from debigulator_tpu_torch.ops import _kernels

    slots, counts, hi = _edge_case(name)
    rec = _edge_records(slots, counts, hi, seed=3)
    n_chunks = len(counts) // tpb.CHUNK_CELLS
    made, zeroed = [], []
    real_zeros = torch.zeros

    def zeros(*a, **k):
        out = real_zeros(*a, **k)
        zeroed.append(out.numel())
        return out

    def no_fill(*a, **k):
        raise AssertionError("an output was filled before the launch")

    monkeypatch.setattr(tpb, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch",
                        lambda entry, *a: made.append((entry, a)))
    monkeypatch.setattr(torch, "zeros", zeros)
    monkeypatch.setattr(torch, "full", no_fill)
    monkeypatch.setattr(torch.Tensor, "fill_", no_fill)
    monkeypatch.setattr(torch.Tensor, "zero_", no_fill)
    before = tpb.compact.launches
    out = tpb.compact(rec, slots)
    monkeypatch.undo()
    assert tpb.compact.launches == before + 1
    assert [e for e, _ in made] == ["dbg_compact"]
    args = made[0][1]
    argtypes = _kernels._ENTRIES["dbg_compact"][1]
    assert len(args) == len(argtypes)
    for a, at in zip(args, argtypes, strict=True):
        assert isinstance(a, torch.Tensor) if at is ctypes.c_void_p \
            else isinstance(a, int)
    status = args[-1]
    assert status.dtype == torch.int64 and status.numel() == 2 * n_chunks + 1
    assert zeroed == [2 * n_chunks + 1]
    assert args[6:10] == (n_chunks, tpb.CHUNK_CELLS * slots,
                          tpb.CHUNK_CELLS * slots // 128 + 2,
                          rec.dm.numel() // 128 + tpb.CHUNK_CELLS * slots // 128
                          + 2 + tpb.DENSE_SLACK_ROWS)
    assert [o.data_ptr() for o in out] == [a.data_ptr() for a in args[10:14]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_size8_matches_reference(name):
    c = case(name)
    mdst, mmeta, _, _ = tpb.compact(c.rec, c.slots)
    _, w1 = pb15._size8_np(mdst.numpy(), mmeta.numpy(), v3.SEG_BYTES, 1)
    want = (w1.astype(np.int64) >> 27) & 0xF
    got = tpb.size8(mdst, mmeta).numpy()
    assert np.array_equal(want, got)
    # The batch rule: a record with size8 == 0 overlaps itself or is wide.
    if name == "rle":
        assert (got[: int((mmeta != 0).sum())] == 0).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_resolve_matches_pallas_and_zlib(name):
    c = case(name)
    plan = c.plan
    n_seg = v3._round_pow2(max(1, -(-plan.out_size // v3.SEG_BYTES)), 1)
    pos = torch.from_numpy(plan.stored_pos.astype(np.int32))
    val = torch.from_numpy(plan.stored_val)
    body = tpb.resolve(*c.a, c.inp.bob_cell, n_seg, pos, val, c.slots)
    got = body[: plan.out_size].to(torch.uint8).numpy().tobytes()
    for off, data in zip(c.offsets, c.datas, strict=True):
        assert got[off : off + len(data)] == data
    pa = build_pa_arrays(c.ref_plan)
    want = _ref_resolve(
        *(jnp.asarray(x.numpy()) for x in c.a),
        jnp.asarray(np.asarray(pa["cellw"])[4]), n_seg=n_seg,
        stored_pos=jnp.asarray(plan.stored_pos),
        stored_val=jnp.asarray(plan.stored_val), slots=c.slots,
        seg_bytes=v3.SEG_BYTES, interpret=True)
    assert np.array_equal(np.asarray(want), body.numpy())


def test_walk_plain_handles_window_prologue():
    """Matches that reach into the window prologue (the tail that the
    long-stream chunked decode carries) read it: tail + body decode as
    one stream."""
    prefix = _words(3000, 5)
    data = prefix + _words(2000, 6) + prefix[-20000:]
    whole = zlib.compressobj(6, zlib.DEFLATED, -15)
    both = whole.compress(prefix) + whole.flush(zlib.Z_FULL_FLUSH)
    rest = whole.compress(data[len(prefix):]) + whole.flush()
    # `rest` on its own refers back into `prefix`: decode it with the
    # last 32 KiB of `prefix` as the window prologue.
    blocks, lengths, cells = scan_stream_cells(both + rest, v3.CELL_BITS)
    first = next(i for i, b in enumerate(blocks)
                 if b.out_start >= len(prefix))
    tail = np.zeros(tpb.WINDOW, np.int32)
    p = np.frombuffer(prefix, np.uint8)[-tpb.WINDOW:]
    tail[-len(p):] = p
    from debigulator_tpu_torch.ops import inflate as inf

    sub = [dataclasses.replace(b, out_start=b.out_start - len(prefix))
           for b in blocks[first:]]
    ncells_before = sum(0 if b.btype == 0 else tp._block_cells(b)
                        for b in blocks[:first])
    st_, pe = cells[0][ncells_before:].astype(np.int64), cells[1][ncells_before:]
    st_ = np.where(st_ >= 0, st_ - 2 * ncells_before * tp.CELL_BITS, -1)
    plan = tp.build_plan_v3(both + rest, sub, lengths[first:],
                            cells=(st_.astype(np.int32), pe, cells[2]))
    body = inf.flagship_body(inf.stage_plan(plan, torch.device("cpu")),
                             tail0=torch.from_numpy(tail))
    got = body[: plan.out_size].to(torch.uint8).numpy().tobytes()
    assert got == data[len(prefix):]


@pytest.mark.parametrize("name", ["text", "merged_pair"])
def test_resolve_card_branch_walks_without_size8(monkeypatch, name):
    """The card's branch of ``resolve``, taken on CPU tensors with the
    launches recorded instead of made: compact, then one launch of dbg_walk
    with the arguments the C entry declares (the whole buffer, the dense
    lists and their lengths, the literal tape), and no size8 pass: the
    source chase needs no batch sizes and no stream bounds, also for a
    merged batch."""
    import ctypes

    from debigulator_tpu_torch.ops import _kernels

    c = case(name)
    plan = c.plan
    n_seg = v3._round_pow2(max(1, -(-plan.out_size // v3.SEG_BYTES)), 1)
    pos = torch.from_numpy(plan.stored_pos.astype(np.int32))
    val = torch.from_numpy(plan.stored_val)
    made = []

    def no_size8(*a, **k):
        raise AssertionError("size8 computed on the card's path")

    monkeypatch.setattr(tpb, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch",
                        lambda entry, *a: made.append((entry, a)))
    monkeypatch.setattr(tpb, "size8", no_size8)
    before = (tpb.compact.launches, tpb.walk.launches)
    body = tpb.resolve(*c.a, c.inp.bob_cell, n_seg, pos, val, c.slots)
    monkeypatch.undo()
    assert (tpb.compact.launches, tpb.walk.launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert [e for e, _ in made] == ["dbg_compact", "dbg_walk"]
    args = made[1][1]
    argtypes = _kernels._ENTRIES["dbg_walk"][1]
    assert len(args) == len(argtypes)
    for a, at in zip(args, argtypes, strict=True):
        assert isinstance(a, torch.Tensor) if at is ctypes.c_void_p \
            else isinstance(a, int)
    out, out_len, window, mdst, mmeta, n_m, rdst, rmeta, n_r, lit, n_lit = args
    assert out_len == out.numel() == tpb.WINDOW + n_seg * v3.SEG_BYTES
    assert window == tpb.WINDOW
    assert body.data_ptr() == out.data_ptr() + 4 * tpb.WINDOW
    dense = made[0][1][10:14]  # compact's outputs feed the walk
    assert [t.data_ptr() for t in (mdst, mmeta, rdst, rmeta)] == \
        [t.data_ptr() for t in dense]
    assert (n_m, n_r) == (mdst.numel(), rdst.numel())
    assert n_lit == lit.numel() and torch.equal(lit, c.rec.lit)
