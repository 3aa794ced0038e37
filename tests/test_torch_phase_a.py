"""Phase A of the PyTorch port against the JAX package's Pallas kernel.

The same plan (built by the JAX package and handed over as numpy through
plan_from_numpy) goes through phase_a13_pallas in interpret mode and the
port's Phase A on the CPU (its plain PyTorch version).  All seven outputs
must be equal (bit-exact, tolerance 0).
"""

import dataclasses
import functools
import zlib

import jax
import numpy as np
import pytest
import torch

from debigulator_tpu.ops import inflate_v3 as v3
from debigulator_tpu.ops.phase_a_pallas import build_pa_arrays, phase_a13_pallas
from debigulator_tpu.ops.scanner import scan_stream_cells
from debigulator_tpu_torch.ops import phase_a as tpa
from debigulator_tpu_torch.ops import plan as tp
from torch_stream_cases import ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


@functools.partial(jax.jit, static_argnames=("slots",))
def _ref_phase_a(pa, slots):
    return phase_a13_pallas(pa, slots, interpret=True)


def _deflate(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(data) + c.flush()


def _text():
    rng = np.random.default_rng(7)
    words = [b"hello ", b"world ", b"tensor ", b"core ", b"\n"]
    return _deflate(b"".join(words[int(v) % 5]
                             for v in rng.integers(0, 5, 3000)))


def _rle():
    return _deflate(b"a" * 5000 + b"bcd" * 700 + b"\x00" * 9000)


def _fixed_random():
    # Low-entropy bytes keep zlib on fixed Huffman instead of stored blocks.
    rng = np.random.default_rng(2)
    data = rng.integers(0, 16, 12_000, dtype=np.uint8).tobytes()
    return _deflate(data, strategy=zlib.Z_FIXED)


def _stored_mix():
    rng = np.random.default_rng(13)
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    st = c.compress(b"prefix text " * 400) + c.flush(zlib.Z_FULL_FLUSH)
    c0 = zlib.compressobj(0, zlib.DEFLATED, -15)
    st += c0.compress(rng.integers(0, 256, 5000, dtype=np.uint8).tobytes())
    st += c0.flush(zlib.Z_FULL_FLUSH)
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    return st + c.compress(b"suffix text " * 400) + c.flush()


STREAMS = {"text": _text, "rle_chain": _rle, "fixed_random": _fixed_random,
           "stored_mix": _stored_mix}


def _plans(stream):
    blocks, lengths, cells = scan_stream_cells(stream, v3.CELL_BITS)
    ref = v3.build_plan_v3(stream, blocks, lengths, cells=cells)
    return ref, tp.plan_from_numpy(dataclasses.asdict(ref))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_phase_a_matches_pallas(name):
    stream = STREAMS[name]()
    ref_plan, plan = _plans(stream)
    pa = build_pa_arrays(ref_plan)
    assert pa is not None
    want = [np.asarray(x) for x in _ref_phase_a(pa, ref_plan.slots)]
    inp = tpa.stage_phase_a_inputs(tpa.build_phase_a_inputs(plan),
                                   torch.device("cpu"))
    got = [x.numpy() for x in tpa.phase_a(inp, plan.slots)]
    names = ("ma", "mb", "ra", "rb", "lit", "cnt", "outlen")
    for n, w, g in zip(names, want, got, strict=True):
        assert w.shape == g.shape and w.dtype == g.dtype, n
        assert np.array_equal(w, g), n
    if name == "fixed_random":
        assert any(b.btype == 1 for b in scan_stream_cells(
            stream, v3.CELL_BITS)[0])  # really a fixed-Huffman stream


def test_phase_a_counts_cover_the_output():
    """The per-cell output lengths add up to the compressed blocks'
    output, and no cell overflows the scanner-exact slot bound."""
    stream = STREAMS["text"]()
    _, plan = _plans(stream)
    inp = tpa.stage_phase_a_inputs(tpa.build_phase_a_inputs(plan),
                                   torch.device("cpu"))
    *_, cnt, outlen = tpa.phase_a(inp, plan.slots)
    assert int(outlen.sum()) == plan.out_size - len(plan.stored_pos)
    for shift in (16, 8, 0):
        assert int(((cnt >> shift) & 0xFF).max()) <= plan.slots


def test_phase_a_rejects_bad_slots():
    _, plan = _plans(STREAMS["text"]())
    inp = tpa.stage_phase_a_inputs(tpa.build_phase_a_inputs(plan),
                                   torch.device("cpu"))
    with pytest.raises(ValueError):
        tpa.phase_a(inp, 12)
