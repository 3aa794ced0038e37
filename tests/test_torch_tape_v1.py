"""The port's first tape resolver (resolve_tape_v1) against the JAX
package's resolve_tape_pallas (Pallas in interpret mode) on the token
cases of tests/test_lz77_pallas.py, and on the port's tape_v3 of a real
stream, on device="cpu" (the kernel's plain version).  Bit-exact."""

import zlib

import numpy as np
import pytest
import torch

from debigulator_tpu.ops import lz77_pallas as ref_lz
from debigulator_tpu.ops.archive import lz77_generations as ref_lzgen
from debigulator_tpu_torch.constants import TOK_MATCH_BIT
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import plan as tp
from debigulator_tpu_torch.ops.archive import lz77_generations as lzgen
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
from torch_stream_cases import STREAMS


def _mk_tape(tokens, slots):
    """tokens: ('lit', v) or ('match', len, dist) -> (cells, slots) tape
    and counts, `slots` tokens a cell."""
    cells = [tokens[i : i + slots] for i in range(0, len(tokens), slots)]
    tape = np.full((len(cells), slots), -1, np.int32)
    counts = np.zeros(len(cells), np.int32)
    for i, row in enumerate(cells):
        for j, t in enumerate(row):
            tape[i, j] = (t[1] if t[0] == "lit"
                          else TOK_MATCH_BIT | (t[1] << 16) | t[2])
        counts[i] = len(row)
    return tape, counts


def _expected(tokens):
    out = bytearray()
    for t in tokens:
        if t[0] == "lit":
            out.append(t[1])
        else:
            for _ in range(t[1]):
                out.append(out[-t[2]])
    return bytes(out)


def _mixed_tokens():
    rng = np.random.default_rng(0)
    toks, n = [], 0
    for _ in range(200):
        if n > 4 and rng.random() < 0.3:
            d = int(rng.integers(1, min(n, 200)))
            ln = int(rng.integers(3, 30))
            toks.append(("match", ln, d))
            n += ln
        else:
            toks.append(("lit", int(rng.integers(0, 256))))
            n += 1
    return toks


TOKENS = {
    "literals_only": [("lit", i % 256) for i in range(100)],
    "simple_match": [("lit", ord(c)) for c in "abcdef"] + [("match", 4, 6)],
    "overlap_rle": [("lit", ord("x")), ("match", 50, 1)],
    "overlap_period3": [("lit", 1), ("lit", 2), ("lit", 3), ("match", 17, 3)],
    "max_length_match": [("lit", i % 256) for i in range(300)]
    + [("match", 258, 300)],
    "mixed_cells": _mixed_tokens(),
}


@pytest.mark.parametrize("slots", [8, 16])
@pytest.mark.parametrize("name", list(TOKENS))
def test_token_cases(name, slots):
    tokens = TOKENS[name]
    tape, counts = _mk_tape(tokens, slots)
    exp = _expected(tokens)
    want = ref_lzgen.resolve_tape_pallas(tape, counts, len(exp), interpret=True)
    got = lzgen.resolve_tape_v1(torch.from_numpy(tape),
                                torch.from_numpy(counts), len(exp))
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == want.tobytes() == exp


@pytest.mark.parametrize("name", ["dynamic", "rle"])
def test_real_stream(name):
    """The port's tensor-op Phase A (tape_v3) feeds both resolvers."""
    stream = STREAMS[name]()
    data = zlib.decompress(stream, -15)
    blocks, lengths, cells = scan_stream_cells(stream, tp.CELL_BITS)
    plan = tp.build_plan_v3(stream, blocks, lengths, cells=cells)
    arrays = tp.plan_arrays_v3(plan, torch.device("cpu"))
    tape, overflow, counts, _ = inf.tape_v3(arrays, plan.n_bits, plan.slots,
                                            exact=plan.exact_entries)
    assert not bool(overflow)
    want = ref_lzgen.resolve_tape_pallas(tape.numpy(), counts.numpy(),
                                         plan.out_size, interpret=True)
    got = lzgen.resolve_tape_v1(tape, counts, plan.out_size)
    assert got.numpy().tobytes() == want.tobytes() == data


def test_output_size_must_match():
    tape, counts = _mk_tape(TOKENS["simple_match"], 8)
    for fn in (lzgen.resolve_tape_v1,
               lambda t, c, n: ref_lzgen.resolve_tape_pallas(
                   t.numpy(), c.numpy(), n, interpret=True)):
        with pytest.raises(ValueError, match="tape output 10 != expected 11"):
            fn(torch.from_numpy(tape), torch.from_numpy(counts), 11)


def test_counts_bound_the_cells():
    """Tokens past a cell's count are not read: a tape whose spare slots
    hold matches gives the same bytes."""
    tokens = TOKENS["mixed_cells"]
    tape, counts = _mk_tape(tokens, 16)
    junk = tape.copy()
    junk[junk == -1] = TOK_MATCH_BIT | (258 << 16) | 1
    got = lzgen.resolve_tape_v1(torch.from_numpy(junk),
                                torch.from_numpy(counts), len(_expected(tokens)))
    assert got.numpy().tobytes() == _expected(tokens)
    assert ref_lz.TOK_MATCH_BIT == TOK_MATCH_BIT


def test_empty_tape():
    got = lzgen.resolve_tape_v1(torch.zeros((0, 8), dtype=torch.int32),
                                torch.zeros(0, dtype=torch.int32), 0)
    assert got.numel() == 0
