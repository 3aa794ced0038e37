"""The archived match-list resolvers of the PyTorch port (v1
``resolve_matches`` and v2 ``resolve_matches_v2``) and their token-tape
drivers against the JAX package's Pallas kernels (interpret mode), a
serial LZ77 walk and zlib, on device="cpu" (the kernels' plain version).
Bit-exact everywhere."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debigulator_tpu.ops import lz77_pallas as ref_lz
from debigulator_tpu.ops.archive import lz77_generations as ref_lg
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import lz77 as lz
from debigulator_tpu_torch.ops import plan as tp
from debigulator_tpu_torch.ops.archive import inflate_generations as ig
from debigulator_tpu_torch.ops.archive import lz77_generations as lg
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
from torch_group_cases import MATCH_LISTS, match_list, serial_matches
from torch_stream_cases import STREAMS, deflate, words

#: Where each layout's body starts: v1 has no pad row.
ORIGIN = {"v1": lz.WINDOW, "v2": lz.BODY_START}
PORT = {"v1": lg.resolve_matches, "v2": lg.resolve_matches_v2}
REF = {"v1": ref_lg.resolve_matches, "v2": ref_lg.resolve_matches_v2}


def _serial(buf, pos, meta):
    out = buf.copy()
    for p, m in zip(pos, meta):
        ln, d = m >> 16, m & 0xFFFF
        for i in range(ln):
            out[p + i] = out[p + i - d]
    return out


def _list_case(version, seed, body=6000, pad_row=1):
    """A window tail of random bytes, a body of literals and matches laid
    out as a valid stream: runs (dist 1-3 < len), full-length matches of
    258, matches reaching back into the window tail (up to 32768), and
    padding: entries of length 0 between matches and one all-padding row.
    Returns (buffer with the literals placed, pos, meta) as numpy."""
    rng = np.random.default_rng(seed)
    origin = ORIGIN[version]
    rows = (origin + body) // 128 + 8
    buf = np.zeros(rows * 128, np.int32)
    buf[origin - lz.WINDOW : origin] = rng.integers(0, 256, lz.WINDOW)
    entries, cur = [], 0
    while cur < body - 300:
        if rng.random() < 0.4:
            n = int(rng.integers(1, 20))
            buf[origin + cur : origin + cur + n] = rng.integers(0, 256, n)
            cur += n
            continue
        kind = int(rng.integers(0, 4))
        ln = 258 if kind == 0 else int(rng.integers(3, 40))
        if kind == 1:
            dist = int(rng.integers(1, 4))
        elif kind == 2:  # into the window tail
            dist = int(rng.integers(cur + 1, lz.WINDOW + 1))
        else:
            dist = int(rng.integers(1, cur + 1)) if cur else 1
        entries.append((origin + cur, (ln << 16) | dist))
        if len(entries) % 7 == 0:
            entries.append((origin, 0))
        cur += ln
    m_rows = -(-len(entries) // 128) + 1
    pos = np.full((m_rows + 1) * 128, origin, np.int32)
    meta = np.zeros((m_rows + 1) * 128, np.int32)
    at = [i + (128 if i >= 128 * pad_row else 0) for i in range(len(entries))]
    pos[at] = [e[0] for e in entries]
    meta[at] = [e[1] for e in entries]
    assert not meta[128 * pad_row : 128 * (pad_row + 1)].any()
    return buf.reshape(rows, 128), pos.reshape(-1, 128), meta.reshape(-1, 128)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_match_list_matches_the_reference_kernel(version, seed):
    buf, pos, meta = _list_case(version, seed)
    m = meta.reshape(-1)
    assert ((m >> 16) == 258).any() and ((m & 0xFFFF) < (m >> 16)).any()
    assert ((m & 0xFFFF) > pos.reshape(-1) - ORIGIN[version]).any()
    want = np.asarray(REF[version](jnp.asarray(buf), jnp.asarray(pos),
                                   jnp.asarray(meta), interpret=True))
    assert np.array_equal(want.reshape(-1),
                          _serial(buf.reshape(-1), pos.reshape(-1), m))
    got = PORT[version](torch.from_numpy(buf), torch.from_numpy(pos),
                        torch.from_numpy(meta))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(MATCH_LISTS))
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_match_list_on_lists_that_rewrite_bytes(version, name):
    """Rows 10e and 10f on hand-made lists that DEFLATE never makes (numpy
    seed 0, a random buffer: its window (and v2's pad row), then 40 rows),
    every entry of the list: a reader between two writers of its source,
    a write after a read, a byte written by three matches, entries of
    distance 0 and length 0, a 258-long overlapping run, 16 clashing
    matches.  The JAX kernels are serial, and the port gives their bytes.
    The first two lists failed on the parent tree, whose plain twin
    followed pointers by doubling (fault C4): body bytes 2010..2019 and
    1000..1019 differed."""
    origin = ORIGIN[version]
    buf, pos, meta, _ = match_list(name, origin, origin)
    want = np.asarray(REF[version](jnp.asarray(buf), jnp.asarray(pos),
                                   jnp.asarray(meta), interpret=True))
    assert np.array_equal(want, serial_matches(buf, pos, meta, pos.size))
    got = PORT[version](*(torch.from_numpy(a.copy()) for a in (buf, pos, meta)))
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, buf)


def test_the_layouts_are_not_converted():
    """Each wrapper takes its own layout: the v2 list on a v1 buffer (or
    the reverse) is refused or resolves other bytes, never silently
    shifted by the pad row."""
    buf, pos, meta = (torch.from_numpy(a) for a in _list_case("v2", 0))
    v2 = lg.resolve_matches_v2(buf, pos, meta)
    v1 = lg.resolve_matches(buf[1:].contiguous(), pos, meta)
    assert not torch.equal(v1.view(-1), v2.view(-1)[128:])
    with pytest.raises(ValueError, match="window prologue"):
        lg.resolve_matches_v2(buf[:200].contiguous(), pos, meta)
    with pytest.raises(ValueError, match="one shape"):
        lg.resolve_matches(buf, pos, meta[:1].contiguous())



@pytest.mark.parametrize("version", ["v1", "v2"])
def test_card_branch_walks_the_whole_list(monkeypatch, version):
    """The card's branch, taken here on CPU tensors with the launch
    recorded instead of made: both layouts launch row 8's chase over
    every entry of the list (no n_matches cut), on a copy of the buffer,
    with the group chase's scratch: three words for every buffer byte, a
    list head for every 512-byte row and a link for every entry."""
    from debigulator_tpu_torch.ops import _kernels

    made = []
    for mod in (lg, lz):
        monkeypatch.setattr(mod, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch",
                        lambda entry, *a: made.append((entry, a)))
    buf, pos, meta = (torch.from_numpy(a) for a in _list_case(version, 0))
    before = PORT[version].launches
    got = PORT[version](buf, pos, meta)
    assert PORT[version].launches == before + 1
    assert len(made) == 1
    entry, (out, n_out, p, m, n, last, first, state, heads, nxt) = made[0]
    assert entry == "dbg_lz77_match" and out is got and out is not buf
    assert n_out == buf.numel() and p is pos and m is meta
    assert n == pos.numel() == nxt.numel()
    assert last.numel() == first.numel() == state.numel() == n_out
    assert state.dtype == torch.int64
    assert heads.numel() == -(-n_out // lz.MATCH_PIECE) + 2


def _tape_inputs(stream):
    blocks, lengths, cells = scan_stream_cells(stream, tp.CELL_BITS)
    plan = tp.build_plan_v3(stream, blocks, lengths, cells=cells)
    arrays = tp.plan_arrays_v3(plan, torch.device("cpu"))
    tape, overflow, _, _ = inf.tape_v3(arrays, plan.n_bits, plan.slots,
                                       exact=True)
    assert not bool(overflow)
    out_rows = inf._round_pow2(
        -(-(plan.out_size + lz.BODY_START + lz.MAXLEN + 512) // 128), 64)
    m_rows = inf._round_pow2(-(-(plan.out_size // 3 + 130) // 128), 16)
    tail = torch.zeros(lz.WINDOW, dtype=torch.int32)
    return plan, (tape, arrays["cell_block"], arrays["block_out_base"],
                  out_rows, m_rows, arrays["stored_pos"], arrays["stored_val"],
                  tail)


DRIVER = {"v1": ig.resolve_tape_matches_v1, "v2": ig.resolve_tape_matches_v2}


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_tape_driver_matches_the_reference_kernel(version):
    """One stream's token tape through match_v4_inputs into the JAX kernel
    and through the port's driver."""
    stream = deflate(words(700, seed=21), 6)
    plan, args = _tape_inputs(stream)
    out_init, pos, meta, _ = inf.match_v4_inputs(*args)
    if version == "v1":
        out_init, pos = out_init[1:], pos - lz.PAD
    want = REF[version](jnp.asarray(out_init.numpy()), jnp.asarray(pos.numpy()),
                        jnp.asarray(meta.numpy()), interpret=True)
    got = DRIVER[version](*args)
    assert np.array_equal(got.numpy(), np.asarray(want))
    body = got.view(-1)[ORIGIN[version] : ORIGIN[version] + plan.out_size]
    assert body.to(torch.uint8).numpy().tobytes() == zlib.decompress(stream, -15)


@pytest.mark.parametrize("version", ["v4", "v1", "v2"])
def test_card_branch_model_on_a_stream(monkeypatch, version):
    """Rows 8, 10e and 10f on one stream's real match list (a token tape
    through match_v4_inputs), the card's branch taken on CPU tensors with
    ``dbg_lz77_match`` run by the model of the chase (groups of one,
    torch_group_cases.emulate): the plain twin's bytes, which decode the
    stream."""
    from debigulator_tpu_torch.ops import _kernels
    from torch_group_cases import emulate

    stream = deflate(words(2000, seed=21), 6)
    plan, args = _tape_inputs(stream)
    out_init, pos, meta, n = inf.match_v4_inputs(*args)
    if version == "v1":
        out_init, pos = out_init[1:].contiguous(), (pos - lz.PAD).contiguous()
    call = {"v4": lambda: lz.resolve_matches_v4(out_init, pos, meta, n),
            "v1": lambda: lg.resolve_matches(out_init, pos, meta),
            "v2": lambda: lg.resolve_matches_v2(out_init, pos, meta)}[version]
    want = call()
    origin = lz.WINDOW if version == "v1" else lz.BODY_START
    body = want.view(-1)[origin : origin + plan.out_size]
    assert body.to(torch.uint8).numpy().tobytes() == zlib.decompress(stream, -15)
    made = []
    for mod in (lg, lz):
        monkeypatch.setattr(mod, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch", emulate(made))
    got = call()
    monkeypatch.undo()
    assert torch.equal(got, want)
    assert [e for e, _ in made] == ["dbg_lz77_match"]


def _text(seed, n=30000):
    rng = np.random.default_rng(seed)
    return bytes(rng.choice(np.frombuffer(b"abcdefgh \n", np.uint8), n))


TAPE_CASES = {
    "level1": lambda: deflate(_text(1), 1),
    "level6": lambda: deflate(_text(6), 6),
    "level9": lambda: deflate(_text(9), 9),
    "mixed": STREAMS["mixed"],
    "rle": STREAMS["rle"],
    "far": STREAMS["far"],
}


@pytest.mark.parametrize("name", list(TAPE_CASES))
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_tape_driver_against_zlib(version, name):
    stream = TAPE_CASES[name]()
    plan, args = _tape_inputs(stream)
    got = DRIVER[version](*args)
    assert got.shape[0] == args[3] - (version == "v1")
    body = got.view(-1)[ORIGIN[version] : ORIGIN[version] + plan.out_size]
    assert body.to(torch.uint8).numpy().tobytes() == zlib.decompress(stream, -15)
    assert ref_lz.PAD == lz.PAD and ref_lz.WINDOW == lz.WINDOW


@pytest.mark.parametrize("name", ["mixed", "rle", "far"])
def test_resolve_tape_segmented_matches_the_reference(name):
    """ops.inflate.resolve_tape_segmented (one call over the body) against
    the reference's segment scan over the v4 match kernel."""
    from debigulator_tpu.ops import inflate_v3 as ref_v3

    stream = STREAMS[name]()
    plan, args = _tape_inputs(stream)
    tape, cell_block, block_out_base = args[:3]
    n_seg = inf.n_segments(plan.out_size)
    want = ref_v3.resolve_tape_segmented(
        jnp.asarray(tape.numpy()), jnp.asarray(cell_block.numpy()),
        jnp.asarray(block_out_base.numpy()), n_seg,
        jnp.asarray(args[5].numpy()), jnp.asarray(args[6].numpy()),
        interpret=True)
    got = inf.resolve_tape_segmented(tape, cell_block, block_out_base, n_seg,
                                     args[5], args[6])
    assert got.dtype == torch.int32 and got.numel() == n_seg * tp.SEG_BYTES
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[: plan.out_size].to(torch.uint8).numpy().tobytes() == \
        zlib.decompress(stream, -15)
