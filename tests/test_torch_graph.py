"""The tensor-op Phase A of the PyTorch port (ops.graph) against the JAX
package's build_graph_v3 and chase_cells on the same plan arrays, in exact
and in speculative mode.  Integers: every comparison is bit-exact."""

import functools

import jax
import numpy as np
import pytest
import torch

from debigulator_tpu.ops import inflate_v3 as v3
from debigulator_tpu.ops.scanner import scan_stream_cells
from debigulator_tpu_torch.ops import graph as tg
from debigulator_tpu_torch.ops import plan as tp
from torch_stream_cases import (
    STREAMS,
    ensure_reference_native,
    to_port_arrays,
    to_port_plan,
)


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


CASES = sorted(set(STREAMS) - {"stored"})
#: Speculative chases: the streams whose entries converge in a few sweeps.
#: Long runs of 8- and 9-bit fixed codes ("fixed", "far") resynchronise
#: about one cell per sweep, which is minutes in either package.
CHASES = [(n, True) for n in CASES] + [
    (n, False) for n in ("dense", "dynamic", "flushed", "mixed", "rle")]


@functools.partial(jax.jit, static_argnames=("n_bits",))
def _ref_graph(arrays, n_bits):
    return v3.build_graph_v3(arrays, n_bits)


@functools.partial(jax.jit, static_argnames=("n_bits", "slots", "exact"))
def _ref_chase(nxt, meta, cell_entry, cell_pend, n_bits, slots, exact):
    return v3.chase_cells(nxt, meta, cell_entry, n_bits, slots,
                          return_counts=True, exact=exact, cell_pend=cell_pend)


def _ref_plan(stream, exact):
    blocks, lengths, cells = scan_stream_cells(stream, v3.CELL_BITS)
    return v3.build_plan_v3(stream, blocks, lengths,
                            cells=cells if exact else None)


@functools.lru_cache(maxsize=None)
def _case(name, exact):
    plan = _ref_plan(STREAMS[name](), exact)
    ref_arrays = v3.plan_arrays_v3(plan)
    nxt, meta = _ref_graph(ref_arrays, plan.n_bits)
    return plan, ref_arrays, np.array(nxt), np.array(meta)


@pytest.mark.parametrize("name", CASES)
def test_build_graph_matches_every_state(name):
    plan, ref_arrays, nxt, meta = _case(name, True)
    got_nxt, got_meta = tg.build_graph(to_port_arrays(ref_arrays), plan.n_bits)
    assert got_nxt.dtype == got_meta.dtype == torch.int32
    assert np.array_equal(got_nxt.numpy(), nxt)
    assert np.array_equal(got_meta.numpy(), meta)


def test_plan_arrays_twin_equals_the_ports_own():
    """The port's plan_arrays_v3 on the carried-over plan gives the same
    tensors as the reference's dict carried over array by array."""
    plan, ref_arrays, _, _ = _case("mixed", False)
    own = tp.plan_arrays_v3(to_port_plan(plan), "cpu")
    twin = to_port_arrays(ref_arrays)
    assert own.keys() == twin.keys()
    for k, v in twin.items():
        if k == "first_state":
            assert own[k] == v
        else:
            assert own[k].dtype == v.dtype and torch.equal(own[k], v), k


@pytest.mark.parametrize(
    "name,exact", CHASES,
    ids=[f"{n}-{'exact' if e else 'speculative'}" for n, e in CHASES])
def test_chase_cells(name, exact):
    plan, ref_arrays, nxt, meta = _case(name, exact)
    want = _ref_chase(nxt, meta, ref_arrays["cell_entry"],
                      ref_arrays["cell_pend"], plan.n_bits, plan.slots, exact)
    arrays = to_port_arrays(ref_arrays)
    tape, overflow, counts, sweeps = tg.chase_cells(
        torch.from_numpy(nxt), torch.from_numpy(meta), arrays["cell_entry"],
        plan.n_bits, plan.slots, exact=exact, cell_pend=arrays["cell_pend"])
    assert np.array_equal(tape.numpy(), np.asarray(want[0]))
    assert bool(overflow) == bool(want[1])
    assert np.array_equal(counts.numpy(), np.asarray(want[2]))
    # The port reaches the same fixpoint in fewer sweeps: it hands an entry
    # that no cell decodes (TERMINAL behind a stream's end) on at once.
    assert (0 < sweeps <= int(want[3])) if not exact else sweeps == 0
    assert bool(overflow) == (name == "dense" and not exact or
                              int(counts.max()) > plan.slots)


def test_fixpoint_needs_more_than_one_sweep():
    """A multi-block stream: only block starts are pinned, so entries
    propagate cell to cell over several sweeps, and the converged tape is
    the exact-entry tape."""
    plan_s, arr_s, nxt, meta = _case("flushed", False)
    arrays = to_port_arrays(arr_s)
    tape_s, _, counts_s, sweeps = tg.chase_cells(
        torch.from_numpy(nxt), torch.from_numpy(meta), arrays["cell_entry"],
        plan_s.n_bits, v3.CELL_BITS)
    assert sweeps > 1
    plan_e, arr_e, nxt_e, meta_e = _case("flushed", True)
    arrays_e = to_port_arrays(arr_e)
    tape_e, _, counts_e, sweeps_e = tg.chase_cells(
        torch.from_numpy(nxt_e), torch.from_numpy(meta_e),
        arrays_e["cell_entry"], plan_e.n_bits, v3.CELL_BITS, exact=True,
        cell_pend=arrays_e["cell_pend"])
    assert sweeps_e == 0
    assert torch.equal(tape_s, tape_e) and torch.equal(counts_s, counts_e)


def test_overflow_retry_at_cell_bits():
    """16 slots overflow on the dense stream; CELL_BITS slots never do, and
    the tape then holds every token of the stream."""
    plan, ref_arrays, nxt, meta = _case("dense", False)
    arrays = to_port_arrays(ref_arrays)
    args = (torch.from_numpy(nxt), torch.from_numpy(meta),
            arrays["cell_entry"], plan.n_bits)
    _, overflow, counts, _ = tg.chase_cells(*args, plan.slots)
    assert plan.slots == v3.DEFAULT_SLOTS and bool(overflow)
    tape, overflow, counts2, _ = tg.chase_cells(*args, v3.CELL_BITS)
    assert not bool(overflow) and torch.equal(counts, counts2)
    assert int((tape >= 0).sum()) == int(counts.sum()) == plan.out_size


def test_terminal_and_out_of_stream_states_are_inactive():
    """nxt is not clipped: TERMINAL (-2) and positions past the stream
    leave every cell's window, and the chase must not index with them."""
    plan, ref_arrays, nxt, meta = _case("dynamic", True)
    assert (nxt == v3.TERMINAL).any() and (nxt >= 2 * plan.n_bits).any()
    arrays = to_port_arrays(ref_arrays)
    want = _ref_chase(nxt, meta, ref_arrays["cell_entry"],
                      ref_arrays["cell_pend"], plan.n_bits, plan.slots, True)
    tape, overflow, counts, _ = tg.chase_cells(
        torch.from_numpy(nxt), torch.from_numpy(meta), arrays["cell_entry"],
        plan.n_bits, plan.slots, exact=True, cell_pend=arrays["cell_pend"])
    assert np.array_equal(tape.numpy(), np.asarray(want[0]))
    assert np.array_equal(counts.numpy(), np.asarray(want[2]))
    # Every state leaving at once, half to TERMINAL and half past the
    # stream: each cell emits its entry state's token at most and stops.
    gone = np.where(np.arange(nxt.size) % 2 == 0, v3.TERMINAL,
                    2 * plan.n_bits + 5).astype(nxt.dtype)
    for exact in (True, False):
        tape, overflow, counts, _ = tg.chase_cells(
            torch.from_numpy(gone), torch.from_numpy(meta),
            arrays["cell_entry"], plan.n_bits, plan.slots, exact=exact,
            cell_pend=arrays["cell_pend"])
        assert not bool(overflow) and int(counts.max()) <= 1
        assert int((tape >= 0).sum()) == int(counts.sum())
