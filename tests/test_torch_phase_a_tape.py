"""The token-tape Phase A of the PyTorch port against the JAX package's
Pallas kernel ``phase_a_pallas`` (interpret mode) and against its
tensor-op Phase A ``_tape_v3_jit(exact=True)`` on the same plan.  On the
CPU the port's wrapper runs its plain version.  Bit-exact."""

import functools

import jax
import numpy as np
import pytest
import torch

from debigulator_tpu.ops import inflate_v3 as v3
from debigulator_tpu.ops.phase_a_pallas import build_pa_arrays, phase_a_pallas
from debigulator_tpu.ops.scanner import scan_stream_cells
from debigulator_tpu_torch.ops import phase_a as tpa
from torch_stream_cases import STREAMS, ensure_reference_native, to_port_plan


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


#: "flushed" packs 73 blocks into a few cells: more blocks in one tile than
#: a table page of the reference kernel holds (build_pa_arrays gives None),
#: a limit the port's inputs do not have.  It is held against the
#: tensor-op Phase A instead.
CASES = sorted(set(STREAMS) - {"stored", "flushed"})


@functools.partial(jax.jit, static_argnames=("slots",))
def _ref_tape(pa, slots):
    return phase_a_pallas(pa, slots, interpret=True)


def _plans(name):
    stream = STREAMS[name]()
    blocks, lengths, cells = scan_stream_cells(stream, v3.CELL_BITS)
    ref = v3.build_plan_v3(stream, blocks, lengths, cells=cells)
    return ref, to_port_plan(ref)


def _port_tape(plan, slots):
    inp = tpa.stage_phase_a_inputs(tpa.build_phase_a_inputs(plan),
                                   torch.device("cpu"))
    return tpa.phase_a_tape(inp, slots)


@pytest.mark.parametrize("name", CASES)
def test_tape_matches_pallas(name):
    ref_plan, plan = _plans(name)
    pa = build_pa_arrays(ref_plan)
    assert pa is not None
    want_tape, want_counts = _ref_tape(pa, ref_plan.slots)
    tape, counts = _port_tape(plan, plan.slots)
    assert tape.dtype == counts.dtype == torch.int32 and tape.is_contiguous()
    assert np.array_equal(tape.numpy(), np.asarray(want_tape))
    assert np.array_equal(counts.numpy(), np.asarray(want_counts))


@pytest.mark.parametrize("name", ["dynamic", "flushed", "mixed", "rle"])
def test_tape_matches_tensor_op_phase_a(name):
    ref_plan, plan = _plans(name)
    want_tape, overflow, want_counts, _ = v3._tape_v3_jit(
        v3.plan_arrays_v3(ref_plan), ref_plan.n_bits, ref_plan.slots,
        exact=True)
    tape, counts = _port_tape(plan, plan.slots)
    n = ref_plan.num_cells
    assert not bool(overflow)
    assert np.array_equal(tape[:n].numpy(), np.asarray(want_tape))
    assert np.array_equal(counts[:n].numpy(), np.asarray(want_counts))
    assert int((tape[n:] >= 0).sum()) == 0 and int(counts[n:].sum()) == 0


def test_counts_past_the_slots_flag_overflow():
    """The dense stream has 31 tokens in a cell; at 16 slots counts exceed
    the slots (the caller's overflow flag), the rows hold the first 16
    tokens, and the reference kernel agrees."""
    ref_plan, plan = _plans("dense")
    assert plan.slots == 32
    tape16, counts16 = _port_tape(plan, 16)
    tape32, counts32 = _port_tape(plan, 32)
    assert int(counts16.max()) > 16 and torch.equal(counts16, counts32)
    assert torch.equal(tape16, tape32[:, :16])
    want_tape, want_counts = _ref_tape(build_pa_arrays(ref_plan), 16)
    assert np.array_equal(tape16.numpy(), np.asarray(want_tape))
    assert np.array_equal(counts16.numpy(), np.asarray(want_counts))


def test_token_packing():
    """Literals are bytes, matches carry TOK_MATCH_BIT | len << 16 | dist,
    empty slots are -1, and the tokens add up to the compressed output."""
    _, plan = _plans("rle")
    tape, counts = _port_tape(plan, plan.slots)
    tok = tape.long()
    used = torch.arange(plan.slots)[None, :] < counts[:, None]
    assert bool((tok[~used] == -1).all()) and bool((tok[used] >= 0).all())
    is_m = used & (tok >= tpa.TOK_MATCH_BIT)
    mlen = (tok >> 16) & 0x3FFF
    assert int(mlen[is_m].max()) == 258 and int((tok[is_m] & 0xFFFF).min()) == 1
    assert int(mlen[is_m].sum() + (used & ~is_m).sum()) == plan.out_size
