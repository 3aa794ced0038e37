"""The first-level decode table of the port's Phase A kernels.

``decode_lut_plain`` (the twin of the table kernel) and ``lut_step_plain``
(the twin of the kernels' lookup: the table entry where it is final, else
the canonical probe) are held exactly against the plain probe ``_probe``
and its aug lookup, at all 2^15 windows in both modes, for the tables the
JAX package's ``build_plan_v3`` gives ``test_torch_phase_a.py``'s streams and
for synthetic code sets (``torch_lut_cases``).  A card-branch test holds
each Phase A wrapper to its launches on the card.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops import phase_a as tpa
from test_torch_phase_a import STREAMS, _plans
from torch_lut_cases import FIXED_LL, synthetic_lut_tables, tables_of_lengths
from torch_stream_cases import STREAMS as MORE_STREAMS
from torch_stream_cases import ensure_reference_native, to_port_plan


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


SYNTHETIC = synthetic_lut_tables()


def _port_inputs(name):
    """Phase A inputs on the CPU from the plan the JAX package builds."""
    if name in STREAMS:
        _, plan = _plans(STREAMS[name]())
    else:
        from debigulator_tpu.ops import inflate_v3 as v3
        from debigulator_tpu.ops.scanner import scan_stream_cells

        stream = MORE_STREAMS[name]()
        blocks, lengths, cells = scan_stream_cells(stream, v3.CELL_BITS)
        plan = to_port_plan(v3.build_plan_v3(stream, blocks, lengths,
                                             cells=cells))
    return plan, tpa.stage_phase_a_inputs(tpa.build_phase_a_inputs(plan),
                                          torch.device("cpu"))


def _tables(case):
    if case in SYNTHETIC:
        return torch.from_numpy(SYNTHETIC[case])
    return _port_inputs(case)[1].tables


def _lut_against_probe(tables, k):
    """Hold the table and its lookup against the probe; returns the share
    of final windows, (nb, 2): per block and mode."""
    lut = tpa.decode_lut_plain(tables, k)
    nb = tables.shape[0]
    assert lut.shape == (nb, 2, 1 << k) and lut.dtype == torch.int32
    if k == tpa.LUT_BITS:  # the wrapper on the CPU: the twin
        assert torch.equal(tpa.decode_lut(tables), lut)
    win = torch.arange(1 << 15, dtype=torch.long).repeat(nb)
    blk = torch.arange(nb, dtype=torch.long).repeat_interleave(1 << 15)
    par = tables[:, :96].long()[blk].T
    flat = tables.reshape(-1).long()
    shares = []
    for mode, (row0, col0, width) in enumerate(((0, tpa.TAB_LL, 288),
                                                (48, tpa.TAB_D, 32))):
        length, aug, final = tpa.lut_step_plain(lut, tables, k, blk, mode, win)
        r_len, r_off, r_un = tpa._probe(tpa._rev15(win), par, row0)
        r_aug = tpa._lookup(flat, blk, col0, width, r_off, r_un)
        assert torch.equal(length, r_len)
        assert torch.equal(aug, r_aug & tpa.LUT_AUG_MASK)
        assert not bool((final & r_un).any())  # a final code is matched
        # A final entry is the probe of every window that shares its k bits.
        entries = lut[:, mode].long()
        fin = (entries & tpa.LUT_FINAL) != 0
        assert bool((entries[~fin] == 0).all())
        shares.append(final.reshape(nb, -1).double().mean(1))
    return torch.stack(shares, 1)


@pytest.mark.parametrize("k", [9, 10])
@pytest.mark.parametrize("case", sorted(STREAMS) + ["flushed"])
def test_lut_matches_probe_on_plan_tables(case, k):
    """Exact on the tables of real streams (one to 73 blocks); their aug
    words fit the entry's 20 bits, and in every block with codes the table
    alone decides most litlen windows."""
    tables = _tables(case)
    aug = tables[:, tpa.TAB_LL:]
    assert torch.equal(aug & tpa.LUT_AUG_MASK, aug)
    share = _lut_against_probe(tables, k)
    coded = tables[:, 1:16].sum(1) > 0
    assert bool(coded.any()) and bool((share[coded, 0] > 0.5).all())
    assert bool((share[~coded] == 0).all())  # a stored block has no code


@pytest.mark.parametrize("k", [9, 10])
@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_lut_matches_probe_on_synthetic_tables(case, k):
    """Exact on code sets no plan gives: incomplete, over-subscribed, one
    1-bit code, every code 15 bits, no distance codes, and rows that follow
    no canonical code; each reaches entries the table leaves to the probe."""
    share = _lut_against_probe(_tables(case), k)
    assert bool((share < 1).any())
    if case != "all_15bit":
        assert bool((share > 0).any())


def test_lut_final_entries_cover_short_codes():
    """On the fixed-Huffman code every symbol is 7-9 bits long, so at k=9
    and k=10 every litlen entry is final, and the lengths are the code's."""
    tables = torch.from_numpy(
        tables_of_lengths(FIXED_LL, np.full(30, 5))[None, :])
    for k in (9, 10):
        ll = tpa.decode_lut_plain(tables, k)[0, 0].long()
        assert bool(((ll & tpa.LUT_FINAL) != 0).all())
        lens = (ll >> tpa.LUT_LEN_SHIFT) & 0xF
        assert set(lens.unique().tolist()) == {7, 8, 9}


READ_BACKS = [(torch.Tensor, n) for n in ("item", "tolist", "cpu", "numpy",
                                         "__int__", "__index__", "__bool__",
                                         "__float__", "nonzero")] + \
    [(torch, "nonzero")]


def test_lut_bits_are_the_kernels():
    """The table kernel's window bits (csrc/phase_a.cu's kLutBits, which
    dbg_phase_a_lut_bits reports) are LUT_BITS, the plain twin's default."""
    src = (_kernels.CSRC / _kernels.SOURCES["phase_a"]).read_text()
    (bits,) = re.findall(r"constexpr int kLutBits = (\d+);", src)
    assert int(bits) == tpa.LUT_BITS
    assert _kernels._CONSTANTS["dbg_phase_a_lut_bits"] == "phase_a"


@pytest.mark.parametrize("slots", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("name", ["phase_a", "phase_a_tape"])
def test_phase_a_card_branch(monkeypatch, name, slots):
    """On the card a Phase A wrapper is two launches and nothing read back:
    the table kernel into a (nb, 2, 2^K) int32 table, K as the kernel
    reports it, then its kernel fed that table, each with its declared
    argument count and types, the launch count moved by one."""
    _, inp = _port_inputs("text")
    fn = getattr(tpa, name)
    entry = {"phase_a": "dbg_phase_a", "phase_a_tape": "dbg_phase_a_tape"}[name]
    events, asked = [], []
    lut_bits = 10  # not LUT_BITS: the wrapper must size from the answer

    def reader(owner, attr):
        real = getattr(owner, attr)

        def read(*a, **k):
            events.append(("read", attr, None))
            return real(*a, **k)
        return read

    def constant(e):
        asked.append(e)
        return lut_bits

    monkeypatch.setattr(tpa, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "constant", constant)
    monkeypatch.setattr(_kernels, "launch",
                        lambda e, *a: events.append(("launch", e, a)))
    for owner, attr in READ_BACKS:
        monkeypatch.setattr(owner, attr, reader(owner, attr))
    before = fn.launches
    out = fn(inp, slots)
    monkeypatch.undo()
    assert fn.launches == before + 1
    assert asked == ["dbg_phase_a_lut_bits"]
    assert [e[:2] for e in events] == [("launch", "dbg_phase_a_lut"),
                                       ("launch", entry)]
    for _, e, args in events:
        argtypes = _kernels._ENTRIES[e][1]
        assert len(args) == len(argtypes), e
        for a, at in zip(args, argtypes, strict=True):
            assert isinstance(a, torch.Tensor) if at is ctypes.c_void_p \
                else type(a) is int, e
    (_, _, (tables, nb, lut)), (_, _, args) = events
    assert tables is inp.tables and nb == inp.tables.shape[0]
    assert lut.dtype == torch.int32 and lut.shape == (nb, 2, 1 << lut_bits)
    cells_pad = inp.cellw.shape[1]
    assert all(a is b for a, b in zip(
        args[:4], (inp.cellw, inp.cell_block, inp.tables, lut), strict=True))
    assert args[4:6] == (cells_pad, slots)
    if name == "phase_a":
        tape, cnt, outlen = args[6:]
        assert tape.shape == (5, slots, cells_pad)
        assert all(o.data_ptr() == tape[i].data_ptr()
                   for i, o in enumerate(out[:5]))
        assert out[5] is cnt and out[6] is outlen
    else:
        tape, counts = args[6:]
        assert tape.shape == (cells_pad, slots)
        assert out[0] is tape and out[1] is counts
