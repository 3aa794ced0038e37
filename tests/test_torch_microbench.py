"""The piece-loop microbenchmark of the PyTorch port (debigulator_tpu_torch/
tools/microbench_pb.py) against the reference tool's Pallas kernel
(tools/microbench_pb.py, run in interpret mode), on device="cpu" (the
kernel's plain version).  Bit-exact for every variant but nodma, whose
output is undefined."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from debigulator_tpu.utils import config as ref_config
from debigulator_tpu_torch.ops.archive import lz77_generations as lg
from debigulator_tpu_torch.tools import microbench_pb as mb

TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "microbench_pb.py"
ROWS = 100
N = 4096


@pytest.fixture(scope="module")
def ref_tool():
    """The reference tool, loaded with its compilation cache off: its
    import would otherwise make .jax_cache/ and set a JAX option for the
    rest of the worker."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config.get_config(), "compilation_cache", "")
        spec = importlib.util.spec_from_file_location("ref_microbench_pb",
                                                      TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _pieces(n=N, rows=ROWS, seed=3):
    """v12 pieces as the tool makes them, placed so that every source
    window lies inside the buffer: stores overlap (dst steps by 16, len up
    to 23), sources are recent stores, and some windows meet row 8."""
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    dst = 4352 + (i * 16) % (rows * 128 - 4352 - 256)
    dist = rng.integers(384, 4096, n)
    ln = np.minimum(rng.integers(4, 24, n), 128 - (dst & 127))
    rp = dst & 127
    q = dst - dist - rp
    r = q & 127
    w0 = ((dst >> 7) << 16) | (rp << 8) | (rp + ln)
    w1 = ((q >> 7) << 16) | (r << 8) | (128 - r)
    init = rng.integers(0, 256, (rows, 128))
    return (w0.reshape(-1, 128).astype(np.int32),
            w1.reshape(-1, 128).astype(np.int32), init.astype(np.int32))


def _ref_run(tool, monkeypatch, variant, w0, w1, init, stage_rows):
    monkeypatch.setattr(tool, "N_PIECES", w0.size)  # read at trace time
    f = pl.pallas_call(
        functools.partial(tool._kernel, variant=variant,
                          stage_rows=stage_rows),
        out_shape=jax.ShapeDtypeStruct(init.shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        input_output_aliases={2: 0}, interpret=True)
    return np.asarray(f(jnp.asarray(w0), jnp.asarray(w1), jnp.asarray(init)))


@pytest.mark.parametrize("variant,stage_rows", [
    ("full", 16), ("full", 32), ("unroll2", 16), ("unroll4", 16),
    ("unroll8", 16), ("load_only", 16), ("store_only", 16),
    ("scalar_only", 16), ("scalar_smem", 16), ("noop", 16), ("noop8", 16)])
def test_variant_matches_the_reference_kernel(ref_tool, monkeypatch, variant,
                                              stage_rows):
    w0, w1, init = _pieces()
    want = _ref_run(ref_tool, monkeypatch, variant, w0, w1, init, stage_rows)
    got = mb.microbench(variant, torch.from_numpy(w0), torch.from_numpy(w1),
                        torch.from_numpy(init), stage_rows)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if variant in ("full", "load_only", "store_only", "scalar_only"):
        assert not np.array_equal(want, init)  # the variant wrote something


def test_load_only_chain_through_the_sum_row():
    """Groups whose windows meet row 8 read the sum the group before them
    stored there: the plain version follows that chain back, checked here
    against a group-by-group loop."""
    w0, w1, init = _pieces(n=2048, seed=5)
    a = torch.from_numpy(w0).view(-1).long()
    b = torch.from_numpy(w1).view(-1).long()
    q = (b >> 16) * 128 + ((b >> 8) & 127)
    flat = torch.from_numpy(init).view(-1).long().clone()
    acc = slice(mb.ACC_ROW * 128, mb.ACC_ROW * 128 + 128)
    meets = 0
    for g in range(0, a.numel(), mb.GROUP):
        rows = [flat[q[g + k] : q[g + k] + 128] for k in range(mb.GROUP)]
        meets += any(q[g + k] + 128 > acc.start and q[g + k] < acc.stop
                     for k in range(mb.GROUP))
        flat[acc] = sum(rows)
    assert meets > 0
    want = mb._wrap32(flat[acc])
    got = mb.microbench_plain("load_only", torch.from_numpy(w0),
                              torch.from_numpy(w1), torch.from_numpy(init))
    assert torch.equal(got.view(-1)[acc], want)


def test_make_pieces_is_the_reference_tools(ref_tool, monkeypatch):
    """make_pieces against the arrays the reference's main() builds (its
    first run is caught before it times anything)."""
    seen = {}

    class Stop(Exception):
        pass

    def catch(variant, w0, w1, init, stage_rows=16):
        seen.update(w0=np.asarray(w0), w1=np.asarray(w1), init=np.asarray(init))
        raise Stop

    assert mb.N_PIECES == ref_tool.N_PIECES
    monkeypatch.setattr(ref_tool, "N_PIECES", 8192)
    monkeypatch.setattr(ref_tool, "run_variant", catch)
    with pytest.raises(Stop):
        ref_tool.main()
    w0, w1 = mb.make_pieces(8192)
    assert np.array_equal(w0, seen["w0"]) and np.array_equal(w1, seen["w1"])
    assert seen["init"].shape == (mb.ROWS, 128)
    assert (mb.ROWS, mb.GROUP, mb.STAGE_ROWS) == (
        ref_tool.ROWS, ref_tool.GROUP, ref_tool.STAGE_ROWS)


def test_nodma_has_no_plain_version():
    w0, w1, init = (torch.from_numpy(a) for a in _pieces(n=2048))
    with pytest.raises(ValueError, match="undefined"):
        mb.microbench("nodma", w0, w1, init)
    with pytest.raises(ValueError, match="unknown"):
        mb.microbench("unroll3", w0, w1, init)


@pytest.mark.parametrize("variant", ["full", "noop8", "nodma"])
def test_card_branch_counts_its_launch(monkeypatch, variant):
    """The card's branch, taken here on CPU tensors with the launch
    recorded instead of made: the packing is checked, one launch per call
    with a whole stage (for full, one of the event chase with at least one
    written word), none without."""
    from debigulator_tpu_torch.ops import _kernels

    made = []
    monkeypatch.setattr(lg, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch",
                        lambda entry, *a: made.append((entry, a)))
    w0, w1, init = (torch.from_numpy(a) for a in _pieces(n=4096))
    before = mb.microbench.launches
    mb.microbench(variant, w0, w1, init, 16)
    mb.microbench(variant, w0[:8], w1[:8], init, 16)  # no whole stage
    assert mb.microbench.launches == before + 1 and len(made) == 1
    entry, args = made[0]
    if variant == "full":
        n_events = int(mb.piece_events(w0, init.numel()).sum())
        assert entry == "dbg_microbench_chase"
        assert args[1] == init.numel() and args[5:7] == (4096, n_events)
        assert int(args[4][-1]) == n_events
    else:
        code, unroll = mb.VARIANTS[variant]
        assert entry == "dbg_microbench_pb"
        assert args[4:] == (2, 16, code, unroll)
    bad = w1.clone()
    bad.view(-1)[5] ^= 1  # low byte no longer 128 - r
    with pytest.raises(ValueError, match="packing"):
        mb.microbench(variant, w0, bad, init, 16)


# ---------------------------------------------------------------------------
# The event chase of full and unrollN on a clashing list
# ---------------------------------------------------------------------------


def _event_model(out, n_out, w0, w1, ends, n_pieces, n_events, order, rows,
                 start, seg, state, seed=0):
    """A model of the C entry dbg_microbench_chase, pass for pass, on CPU
    tensors: the pieces bucketed by the row of their first word (in a
    shuffled order, as atomics place them) and each bucket sorted, each
    word's writers listed from its row's bucket, the events of the pieces
    (csrc's for_events), the pointer search, the chase by pointer jumping
    with owner-only stores, the store.  Checks the scratch it is given."""
    assert order.dtype == rows.dtype == start.dtype == seg.dtype == torch.int32
    assert state.dtype == torch.int64
    assert order.numel() == n_pieces and rows.numel() == 4 * (-(-n_out // 128) + 1)
    assert start.numel() == n_out + 1
    assert seg.numel() == state.numel() == n_events
    a = w0.reshape(-1)[:n_pieces].numpy().astype(np.int64)
    b = w1.reshape(-1)[:n_pieces].numpy().astype(np.int64)
    end = ends.numpy().astype(np.int64)
    assert end.shape == (n_pieces,) and end[-1] == n_events
    excl = np.concatenate([[0], end[:-1]])
    base = (a >> 16) * 128
    p0 = np.maximum(base + ((a >> 8) & 127), 0)
    shift = (b >> 16) * 128 + ((b >> 8) & 127) - base
    n_rows = -(-n_out // 128)
    row = np.minimum(p0 >> 7, n_rows - 1)
    shuffled = np.random.default_rng(seed).permutation(n_pieces)
    by_row = shuffled[np.argsort(row[shuffled], kind="stable")]
    bounds = np.searchsorted(row[by_row], np.arange(n_rows + 1))
    for r in range(n_rows):  # the sort of each bucket
        by_row[bounds[r]:bounds[r + 1]].sort()
    order.copy_(torch.from_numpy(by_row.astype(np.int32)))
    t = np.repeat(np.arange(n_pieces), end - excl)
    e = np.arange(n_events)
    p = p0[t] + e - excl[t]
    s = p + shift[t]
    glo = excl[t & ~(mb.GROUP - 1)]
    assert ((p >= 0) & (p < n_out)).all()
    assert (p >> 7 == row[t]).all()  # a piece writes within its row
    counts = np.bincount(p, minlength=n_out)
    first = np.concatenate([[0], np.cumsum(counts)])
    fill = first[:-1].copy()
    segs = np.empty(n_events, np.int64)
    for x in by_row:  # the rows' lists: each bucket in slot order
        for y in range(excl[x], end[x]):
            segs[fill[p[y]]] = y
            fill[p[y]] += 1
    flat = out.view(-1).numpy()
    inside = (s >= 0) & (s < n_out)
    ptr = np.full(n_events, -1)
    val = np.zeros(n_events, np.int64)
    for x in np.flatnonzero(inside):  # the pointer search
        lo, hi = first[s[x]], first[s[x] + 1]
        k = lo + np.searchsorted(segs[lo:hi], glo[x])
        if k > lo:
            ptr[x] = segs[k - 1]
        else:
            val[x] = flat[s[x]]
    assert (ptr < glo).all()  # every pointer names an earlier group
    while (ptr >= 0).any():  # the chase
        live = ptr >= 0
        tgt = ptr[live]
        done = ptr[tgt] < 0
        val[np.flatnonzero(live)[done]] = val[tgt[done]]
        nxt = np.where(done, -1, ptr[tgt])
        ptr[live] = nxt
    written = np.flatnonzero(counts)
    flat[written] = val[segs[first[written + 1] - 1]]  # the store
    start.copy_(torch.from_numpy(first.astype(np.int32)))
    seg.copy_(torch.from_numpy(segs.astype(np.int32)))


def test_clash_list_is_what_it_claims():
    """clash_pieces: two pieces of one group write one word, pieces read
    words their own group writes, every word of rows 8-15 is written 20
    times or more and no other word, and the sources before the buffer
    meet zeros only."""
    w0, w1, init = mb.clash_pieces()
    a = w0.reshape(-1).astype(np.int64)
    b = w1.reshape(-1).astype(np.int64)
    base, rp, hi = (a >> 16) * 128, (a >> 8) & 127, a & 255
    q = (b >> 16) * 128 + ((b >> 8) & 127)
    t = np.repeat(np.arange(a.size), hi - rp)
    i = np.arange(t.size) - np.repeat(np.cumsum(hi - rp) - (hi - rp), hi - rp)
    p, s, g = base[t] + rp[t] + i, q[t] + rp[t] + i, t // mb.GROUP
    counts = np.bincount(p, minlength=init.size)
    assert counts[:8 * 128].sum() == counts[16 * 128:].sum() == 0
    assert counts[8 * 128:16 * 128].min() >= 20
    pairs = set(zip(g.tolist(), p.tolist()))
    assert len(pairs) < p.size  # a group writes a word twice
    assert len(pairs & set(zip(g.tolist(), s.tolist()))) > 50
    assert (s < 0).sum() > 0 and not init[:2].any() and not init[-2:].any()


@pytest.mark.parametrize("variant", ["full", "unroll2", "unroll4", "unroll8"])
def test_clash_list_matches_the_reference_kernel(ref_tool, monkeypatch,
                                                 variant):
    w0, w1, init = mb.clash_pieces()
    want = _ref_run(ref_tool, monkeypatch, variant, w0, w1, init, 16)
    got = mb.microbench(variant, torch.from_numpy(w0), torch.from_numpy(w1),
                        torch.from_numpy(init))
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy() != init).sum() > 900


@pytest.mark.parametrize("case", ["clash", "pieces", "past_end"])
def test_event_chase_card_branch(ref_tool, monkeypatch, case):
    """full's card branch with the C entry replaced by _event_model: one
    read-back (the packing and the event count), then one entry, the event
    chase, with its scratch sized from that count and nothing read back
    after it; one count per call; the reference kernel's buffer.  past_end:
    a buffer of 60 rows, which many pieces write past and read past (the
    plain version's buffer: the reference leaves such stores undefined)."""
    from debigulator_tpu_torch.ops import _kernels

    w0, w1, init = mb.clash_pieces() if case == "clash" else _pieces()
    if case == "past_end":
        init = np.ascontiguousarray(init[:60])
        want = mb.microbench_plain("full", torch.from_numpy(w0),
                                   torch.from_numpy(w1),
                                   torch.from_numpy(init)).numpy()
    else:
        want = _ref_run(ref_tool, monkeypatch, "full", w0, w1, init, 16)
    made, modelling = [], []

    def refuse_after_launch(real):
        def guarded(*a, **k):
            if made and not modelling:
                raise AssertionError("read back to the host after the launch")
            return real(*a, **k)

        return guarded

    def launch(entry, *args):
        made.append((entry, args))
        modelling.append(True)
        _event_model(*args)
        modelling.clear()

    monkeypatch.setattr(lg, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch", launch)
    for name in ("item", "tolist", "__bool__", "__int__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name,
                            refuse_after_launch(getattr(torch.Tensor, name)))
    tw0, tw1, tinit = (torch.from_numpy(x) for x in (w0, w1, init))
    before = mb.microbench.launches
    got = mb.microbench("full", tw0, tw1, tinit)
    monkeypatch.undo()
    assert mb.microbench.launches == before + 1
    assert [e for e, _ in made] == ["dbg_microbench_chase"]
    args = made[0][1]
    assert len(args) == len(_kernels._ENTRIES["dbg_microbench_chase"][1])
    n_events = int(mb.piece_events(tw0, tinit.numel()).sum())
    unclipped = int(mb.piece_events(tw0, 1 << 30).sum())
    assert args[6] == n_events > 10 * 1024
    assert (n_events < unclipped) == (case == "past_end")
    scratch = sum(x.numel() * x.element_size() for x in (args[4], *args[7:]))
    assert scratch == mb.chase_scratch_bytes(tinit.numel(), tw0.numel(),
                                             n_events)
    assert np.array_equal(got.numpy(), want)
