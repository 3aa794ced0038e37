"""Device inflate entry points and decode drivers (the device half of
debigulator_tpu/ops/inflate_v3.py).

The flagship (``flagship_body`` :1405): Phase A (CUDA kernel) -> glue ->
compact (CUDA kernel) -> walk (CUDA kernels), leaving the decoded bytes on
the device as int32 values; ``inflate_device_long_stream`` (:1549) chunks
a stream over the per-call cap.

The other drivers, each named after the reference's jit it ports:

=============  ==========================  ===============================
driver         Phase A                     Phase B
=============  ==========================  ===============================
inflate_v3     ops.graph (tensor ops)      resolve_tape_torch (tensor ops)
inflate_v4     ops.graph                   resolve_tape_fused ->
                                           lz77.resolve_matches_v4
inflate_v5     ops.graph                   resolve_tape_segmented_v6 ->
                                           lz77.resolve_tape_v6
inflate_v7     phase_a.phase_a_tape        resolve_tape_segmented_v6
inflate_v13    phase_a.phase_a             resolve_ops_segmented_v13 ->
                                           lz77.resolve_ops_v13
=============  ==========================  ===============================

``inflate_device_dev`` selects as the reference's ``inflate_device_v3_dev``
does (:1171-1276): stored-only streams on the host; scanner-exact entries
-> the flagship, or v13 under ``DBG_PHASE_B=v13`` (read at call time);
speculative entries (the Python scan, ``DBG_NO_NATIVE=1``) -> v4 up to
``lz77.OUT_CAP`` bytes of output and v5 above; ``use_kernels=False`` ->
the all-tensor-op v3.  A tape overflow is retried once at ``CELL_BITS``
slots, which cannot overflow.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.constants import TOK_MATCH_BIT
from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.native.scanner import inflate_native
from debigulator_tpu_torch.ops import lz77 as lz
from debigulator_tpu_torch.ops import phase_b
from debigulator_tpu_torch.ops import plan as _plan
from debigulator_tpu_torch.ops.graph import (
    build_graph,
    chase_cells,
)
from debigulator_tpu_torch.ops.phase_a import (
    PhaseAInputs,
    build_phase_a_inputs,
    phase_a,
    phase_a_tape,
    stage_phase_a_inputs,
)
from debigulator_tpu_torch.ops.plan import (
    CELL_BITS,
    SEG_BYTES,
    TC,
    TERMINAL,
    PlanV3,
    _block_cells,
    _round_pow2,
    build_plan_v3,
    plan_arrays_v3,
    v15_stream_too_large,
)
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
from debigulator_tpu_torch.utils.config import get_config
from debigulator_tpu_torch.utils.profiling import named_scope


class SingleBlockTooLarge(RuntimeError):
    """One DEFLATE block alone exceeds the per-call cap (it cannot be split
    at a block boundary)."""


@dataclasses.dataclass
class StagedPlan:
    """A plan's device inputs: Phase A's and the stored-block bytes."""

    pa: PhaseAInputs
    stored_pos: torch.Tensor
    stored_val: torch.Tensor
    slots: int
    n_seg: int
    #: True when ``slots`` is the scanner's exact bound (no tape overflows).
    slots_exact: bool = True


def n_segments(out_size: int) -> int:
    return _round_pow2(max(1, -(-out_size // SEG_BYTES)), 1)


def stage_plan(plan: PlanV3, device: torch.device) -> StagedPlan:
    """Stage an exact-entry plan's device inputs (a merged plan's streams
    need no boundaries: the walk resolves them as one)."""
    with named_scope("dbg.stage"):
        with named_scope("dbg.stage.pack"):
            host = build_phase_a_inputs(plan)
            stored_pos = np.asarray(plan.stored_pos, np.int32)
            stored_val = np.asarray(plan.stored_val, np.uint8)
        with named_scope("dbg.stage.h2d"):
            return StagedPlan(
                pa=stage_phase_a_inputs(host, device),
                stored_pos=torch.from_numpy(stored_pos).to(device),
                stored_val=torch.from_numpy(stored_val).to(device),
                slots=plan.slots,
                n_seg=n_segments(plan.out_size),
                slots_exact=plan.slots_exact,
            )


def flagship_body(st: StagedPlan, tail0=None) -> torch.Tensor:
    """Phase A + Phase B on a staged plan: the body, int32 one byte per
    element, n_seg*SEG_BYTES long.  tail0: the 32 KiB window before the
    body (zeros for a stream head).  The plan's slot count must be the
    scanner's exact per-cell token bound, so no tape can overflow."""
    if not st.slots_exact:
        raise ValueError("the plan needs the scanner's exact slot bound")
    with named_scope("phase_a_huffman"):
        ma, mb, ra, rb, lit, cnt, outlen = phase_a(st.pa, st.slots)
    with named_scope("phase_b_lz77"):
        return phase_b.resolve(ma, mb, ra, rb, lit, cnt, outlen,
                               st.pa.bob_cell, st.n_seg, st.stored_pos,
                               st.stored_val, st.slots, tail0=tail0)


# ---------------------------------------------------------------------------
# Phase B of the other drivers: glue around the lz77 resolvers
# ---------------------------------------------------------------------------


def _token_lengths(flat: torch.Tensor):
    """(valid, is_match, match length, output bytes) of a flat token tape."""
    valid = flat >= 0
    is_match = flat >= TOK_MATCH_BIT
    mlen = (flat >> 16) & 0x3FFF
    out_len = torch.where(is_match, mlen, valid.to(torch.int32))
    return valid, is_match, mlen, out_len


def resolve_tape_torch(tape, cell_block, block_out_base, out_size: int,
                       stored_pos, stored_val) -> torch.Tensor:
    """All-tensor-op LZ77 resolver (the reference's ``resolve_tape_xla``):
    literals scattered, every byte pointed at the byte ``dist`` before it
    (``dist`` filled forward from the last token start at or before the
    byte), pointers doubled until nothing changes.  Returns (out_size,)
    uint8.  Masked lanes of the scatters go to a dump slot ``out_size``."""
    slots = tape.shape[1]
    dev = tape.device
    flat = tape.reshape(-1)
    valid, is_match, _, out_len = _token_lengths(flat)
    base = block_out_base.long()[cell_block.long()].repeat_interleave(slots)
    out_pos = base + torch.cumsum(out_len.long(), 0) - out_len

    valid = valid & (out_pos < out_size)  # an index past the end is dropped
    out_val = torch.zeros(out_size + 1, dtype=torch.int32, device=dev)
    lit_mask = valid & ~is_match
    out_val[torch.where(lit_mask, out_pos, out_size)] = \
        torch.where(lit_mask, flat, 0)
    # Marker: dist at match starts, 0 at literal starts and stored bytes.
    mark_tgt = torch.where(valid, out_pos, out_size)
    m_dist = torch.zeros(out_size + 1, dtype=torch.long, device=dev)
    m_dist[mark_tgt] = torch.where(is_match, flat & 0xFFFF, 0).long()
    m_mark = torch.zeros(out_size + 1, dtype=torch.bool, device=dev)
    m_mark[mark_tgt] = valid
    if stored_val.numel():
        sp = stored_pos.long()
        out_val[sp] = stored_val.to(torch.int32)
        m_dist[sp] = 0
        m_mark[sp] = True

    # Fill-forward: each byte takes the last marker at or before it.
    i = torch.arange(out_size + 1, device=dev)
    last = torch.cummax(torch.where(m_mark, i, -1), 0).values
    dist_ff = torch.where(last >= 0, m_dist[last.clamp(min=0)], 0)
    parent = torch.where(dist_ff > 0, i - dist_ff, i).clamp(0, out_size)
    while True:
        nxt = parent[parent]
        if torch.equal(nxt, parent):
            break
        parent = nxt
    return out_val[parent][:out_size].to(torch.uint8)


def match_v4_inputs(tape, cell_block, block_out_base, out_rows: int,
                    m_rows: int, stored_pos, stored_val, tail):
    """Inputs of ``lz77.resolve_matches_v4`` from a token tape: (out_init
    with literals, stored bytes and window tail placed, pos, meta,
    n_matches).  Matches are compacted in order; the least match length is
    3, so m_rows * 128 >= out_size / 3 entries cannot overflow."""
    slots = tape.shape[1]
    dev = tape.device
    flat = tape.reshape(-1)
    valid, is_match, mlen, out_len = _token_lengths(flat)
    base = block_out_base.long()[cell_block.long()].repeat_interleave(slots)
    out_pos = base + torch.cumsum(out_len.long(), 0) - out_len + lz.BODY_START

    total = out_rows * 128
    out_flat = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    out_flat[lz.PAD : lz.BODY_START] = tail.reshape(-1)
    lit_mask = valid & ~is_match & (out_pos < total)
    out_flat[torch.where(lit_mask, out_pos, total)] = \
        torch.where(lit_mask, flat, 0)
    if stored_val.numel():
        out_flat[stored_pos.long() + lz.BODY_START] = stored_val.to(torch.int32)

    m_cap = m_rows * 128
    midx = torch.cumsum(is_match.long(), 0) - 1
    tgt = torch.where(is_match & (midx < m_cap), midx, m_cap)
    mpos = torch.full((m_cap + 1,), lz.BODY_START, dtype=torch.int32,
                      device=dev)
    mpos[tgt] = out_pos.to(torch.int32)
    mmeta = torch.zeros(m_cap + 1, dtype=torch.int32, device=dev)
    mmeta[tgt] = torch.where(is_match, (mlen << 16) | (flat & 0xFFFF), 0)
    return (out_flat[:total].view(out_rows, 128),
            mpos[:m_cap].view(m_rows, 128), mmeta[:m_cap].view(m_rows, 128),
            is_match.sum())


def resolve_tape_fused(tape, cell_block, block_out_base, out_rows: int,
                       m_rows: int, stored_pos, stored_val,
                       tail) -> torch.Tensor:
    """Phase B of v4: tensor ops scatter the literals and compact the
    matches in order, ``lz77.resolve_matches_v4`` resolves the copies.
    tail: (WINDOW,) int32 window prologue (zeros for a stream head).
    Returns the (out_rows, 128) int32 buffer (pad row and window first)."""
    out_init, pos, meta, n = match_v4_inputs(
        tape, cell_block, block_out_base, out_rows, m_rows, stored_pos,
        stored_val, tail)
    return lz.resolve_matches_v4(out_init, pos, meta, n_matches=n)


def resolve_tape_segmented(tape, cell_block, block_out_base, n_seg: int,
                           stored_pos, stored_val) -> torch.Tensor:
    """Phase B of any output size from a token tape through
    ``lz77.resolve_matches_v4``: the body, (n_seg * SEG_BYTES,) int32.

    The counterpart of the reference's ``resolve_tape_segmented``
    (inflate_v3.py:897-981, which no path calls).  The reference cuts the
    matches at 512 KiB segment edges and walks the segments through its
    match kernel with the window carried, because a segment must fit its
    VMEM; the card holds the whole body, so as in ``resolve_tape_fused``
    one call covers it: literals and stored bytes placed, matches compacted
    in order.  Bytes past the body are dropped, as the reference drops
    them."""
    total = n_seg * SEG_BYTES
    out_rows = (lz.BODY_START + total) // 128 + lz.SLACK_ROWS
    m_rows = -(-(total // 3 + 130) // 128)
    tail = torch.zeros(lz.WINDOW, dtype=torch.int32, device=tape.device)
    return _body_of(resolve_tape_fused(tape, cell_block, block_out_base,
                                       out_rows, m_rows, stored_pos,
                                       stored_val, tail))


def _segment_buffer(n_seg: int, stored_pos, stored_val, device):
    """(rows, 128) buffer of a whole-body resolve: pad row, zero window,
    n_seg * SEG_BYTES of body with the stored bytes placed, slack rows."""
    rows = (lz.BODY_START + n_seg * SEG_BYTES) // 128 + lz.SLACK_ROWS
    out = torch.zeros((rows, 128), dtype=torch.int32, device=device)
    if stored_val.numel():
        out.view(-1)[stored_pos.long() + lz.BODY_START] = \
            stored_val.to(torch.int32)
    return out


def _rows128(t: torch.Tensor, fill: int = 0) -> torch.Tensor:
    """A flat tensor as (rows, 128), padded to whole rows."""
    t = t.reshape(-1)
    pad = -t.numel() % 128
    if pad:
        t = torch.cat([t, t.new_full((pad,), fill)])
    return t.contiguous().view(-1, 128)


def _body_of(out2d: torch.Tensor) -> torch.Tensor:
    return out2d.view(-1)[lz.BODY_START : -lz.SLACK_ROWS * 128]


def tape_v6_inputs(tape, counts, bob_cell, n_seg: int, stored_pos,
                   stored_val):
    """Arguments of one whole-body ``lz77.resolve_tape_v6`` call from a
    token tape: per-cell output bases (one cells-sized cumsum), the cell
    axis padded to rows of 128."""
    cells, slots = tape.shape
    _, _, _, out_len = _token_lengths(tape)
    cell_len = out_len.sum(1)
    cbase = (bob_cell.long() + torch.cumsum(cell_len, 0) - cell_len)
    pad_c = -cells % 128  # counts and cbase are rows of 128 cells
    if pad_c:
        tape = torch.cat([tape, tape.new_full((pad_c, slots), -1)])
    return (_segment_buffer(n_seg, stored_pos, stored_val, tape.device),
            _rows128(tape), _rows128(counts.to(torch.int32)),
            _rows128(cbase.to(torch.int32)), 0, cells, 0, slots)


def resolve_tape_segmented_v6(tape, counts, bob_cell, n_seg: int,
                              stored_pos, stored_val) -> torch.Tensor:
    """Phase B of v5 and v7 from the token tape, through
    ``lz77.resolve_tape_v6``.  Returns the body, (n_seg * SEG_BYTES,)
    int32.

    The reference scans 512 KiB segments and carries the window tail from
    one kernel call to the next because a segment must fit its VMEM; the
    card holds the whole body, so this is one call over all cells with
    ``cell_lo = 0``, ``cell_hi = cells``, ``seg_off = 0``."""
    return _body_of(lz.resolve_tape_v6(*tape_v6_inputs(
        tape, counts, bob_cell, n_seg, stored_pos, stored_val)))


def ops_v13_inputs(ma, mb, ra, rb, lit, cnt, outlen, bob_cell, n_seg: int,
                   stored_pos, stored_val, slots: int):
    """Arguments of one whole-body ``lz77.resolve_ops_v13`` call from
    Phase A's tapes ((slots, cells_pad) each): the tapes turned cell-major
    and the per-cell output bases."""
    cells_pad = ma.shape[1]
    cl = outlen.long()
    bob = bob_cell.long()
    if bob.numel() < cells_pad:
        bob = torch.cat([bob, bob.new_zeros(cells_pad - bob.numel())])
    cbase = bob + torch.cumsum(cl, 0) - cl
    return (_segment_buffer(n_seg, stored_pos, stored_val, ma.device),
            *(_rows128(t.T) for t in (ma, mb, ra, rb, lit)),
            _rows128(cnt.to(torch.int32)), _rows128(cbase.to(torch.int32)),
            0, cells_pad, 0, slots)


def resolve_ops_segmented_v13(ma, mb, ra, rb, lit, cnt, outlen, bob_cell,
                              n_seg: int, stored_pos, stored_val,
                              slots: int) -> torch.Tensor:
    """Phase B of v13 from Phase A's tapes, through
    ``lz77.resolve_ops_v13`` once over the whole body (see
    ``resolve_tape_segmented_v6``).  bob_cell: (num_cells,) or
    (cells_pad,).  Returns the body, (n_seg * SEG_BYTES,) int32."""
    return _body_of(lz.resolve_ops_v13(*ops_v13_inputs(
        ma, mb, ra, rb, lit, cnt, outlen, bob_cell, n_seg, stored_pos,
        stored_val, slots)))


# ---------------------------------------------------------------------------
# The decode drivers
# ---------------------------------------------------------------------------


def tape_v3(arrays: dict, n_bits: int, slots: int, exact: bool = False):
    """Tensor-op Phase A alone: (tape, overflow, counts, sweeps)."""
    nxt, meta = build_graph(arrays, n_bits)
    return chase_cells(nxt, meta, arrays["cell_entry"], n_bits, slots,
                       exact=exact, cell_pend=arrays["cell_pend"])


def inflate_v3(arrays: dict, n_bits: int, slots: int, out_size: int,
               exact: bool = False):
    """All tensor ops, no kernel: (out (out_size,) uint8, overflow,
    sweeps)."""
    tape, overflow, _, sweeps = tape_v3(arrays, n_bits, slots, exact)
    out = resolve_tape_torch(tape, arrays["cell_block"],
                             arrays["block_out_base"], out_size,
                             arrays["stored_pos"], arrays["stored_val"])
    return out, overflow, sweeps


def inflate_v4(arrays: dict, n_bits: int, slots: int, out_rows: int,
               m_rows: int, exact: bool = False):
    """Tensor-op Phase A + the match-list kernel: (out2d (out_rows, 128)
    with pad row and window first, overflow)."""
    tape, overflow, _, _ = tape_v3(arrays, n_bits, slots, exact)
    tail = torch.zeros(lz.WINDOW, dtype=torch.int32, device=tape.device)
    out2d = resolve_tape_fused(tape, arrays["cell_block"],
                               arrays["block_out_base"], out_rows, m_rows,
                               arrays["stored_pos"], arrays["stored_val"],
                               tail)
    return out2d, overflow


def inflate_v5(arrays: dict, n_bits: int, slots: int, n_seg: int,
               exact: bool = False):
    """Tensor-op Phase A + the tape kernel, any output size: (body,
    overflow)."""
    tape, overflow, counts, _ = tape_v3(arrays, n_bits, slots, exact)
    body = resolve_tape_segmented_v6(tape, counts, arrays["bob_cell"], n_seg,
                                     arrays["stored_pos"],
                                     arrays["stored_val"])
    return body, overflow


def inflate_v7(pa: PhaseAInputs, arrays: dict, slots: int, n_seg: int,
               num_cells: int):
    """Token-tape Phase A kernel + the tape kernel: (body, overflow).
    arrays: stored_pos/stored_val (plan.plan_arrays_v7)."""
    tape, counts = phase_a_tape(pa, slots)
    tape, counts = tape[:num_cells], counts[:num_cells]
    overflow = (counts > slots).any()
    body = resolve_tape_segmented_v6(tape, counts, pa.bob_cell[:num_cells],
                                     n_seg, arrays["stored_pos"],
                                     arrays["stored_val"])
    return body, overflow


def inflate_v13(pa: PhaseAInputs, arrays: dict, slots: int, n_seg: int):
    """Phase A kernel (match, run and literal tapes) + the op kernel:
    (body, overflow); overflow is False whenever ``slots`` is the
    scanner's exact bound."""
    ma, mb, ra, rb, lit, cnt, outlen = phase_a(pa, slots)
    overflow = (((cnt >> 16) > slots) | (((cnt >> 8) & 0xFF) > slots)
                | ((cnt & 0xFF) > slots)).any()
    body = resolve_ops_segmented_v13(ma, mb, ra, rb, lit, cnt, outlen,
                                     pa.bob_cell, n_seg,
                                     arrays["stored_pos"],
                                     arrays["stored_val"], slots)
    return body, overflow


def phase_b_generation() -> str:
    """"v13" when DBG_PHASE_B=v13 selects the previous-generation Phase B
    for exact-entry plans, else "v15" (the flagship).  Read at call time."""
    return "v13" if os.environ.get("DBG_PHASE_B", "v15") == "v13" else "v15"


def _retry_on_overflow(call, slots: int, probe: bool = True):
    """call(slots) -> (result, overflow).  With ``probe``, an overflowed
    tape is decoded again at CELL_BITS slots, the bound no cell exceeds."""
    out, overflow = call(slots)
    if probe and bool(overflow):
        out, overflow = call(CELL_BITS)
        if bool(overflow):
            raise RuntimeError("tape overflow at the exact slot bound")
    return out


def inflate_device_dev(data: bytes, scanned=None, device="cuda",
                       use_kernels: bool | None = None):
    """Device inflate of one raw DEFLATE stream, output left on the device.

    Returns (body, out_size): body is a flat int32 tensor (one byte per
    element, >= out_size long).  scanned: optional (blocks, lengths, cells)
    from scan_stream_cells, so a container codec that already indexed the
    stream does not pay a second scan.  use_kernels=False takes the
    all-tensor-op driver v3 whatever the plan (the counterpart of the
    reference's ``force_pallas=False``); None takes
    ``Config.use_kernels``, True unless a caller turned it off.  The module
    docstring has the selection.
    """
    dev = resolve_device(device)
    if use_kernels is None:
        use_kernels = get_config().use_kernels
    if scanned is not None:
        blocks, lengths, cells = scanned
    else:
        with named_scope("dbg.scan"):
            blocks, lengths, cells = scan_stream_cells(data, CELL_BITS)
    with named_scope("dbg.plan"):
        plan = build_plan_v3(data, blocks, lengths, cells=cells)
    if plan.first_state == TERMINAL:  # stored-only stream
        with named_scope("dbg.stage"):
            out = np.zeros(plan.out_size, np.int32)
            out[plan.stored_pos] = plan.stored_val
            return torch.from_numpy(out).to(dev), plan.out_size
    exact = plan.exact_entries
    probe = not plan.slots_exact
    n_seg = n_segments(plan.out_size)
    if use_kernels and exact:
        if v15_stream_too_large(plan):
            try:
                return inflate_device_long_stream(data, blocks, lengths, cells,
                                                  device=dev)
            except SingleBlockTooLarge:
                # One unsplittable block over the cap (a single-block encode
                # of 16 MB and more): native serial inflate, staged to the
                # device.
                with named_scope("dbg.stage"):
                    out = np.frombuffer(inflate_native(data)[0], np.uint8)
                    return (torch.from_numpy(out.astype(np.int32)).to(dev),
                            len(out))
        st = stage_plan(plan, dev)
        if phase_b_generation() != "v13":
            return flagship_body(st), plan.out_size
        stored = {"stored_pos": st.stored_pos, "stored_val": st.stored_val}
        return _retry_on_overflow(
            lambda k: inflate_v13(st.pa, stored, k, n_seg), plan.slots,
            probe), plan.out_size

    with named_scope("dbg.stage"):
        arrays = plan_arrays_v3(plan, dev)
    if use_kernels and plan.out_size + 512 > lz.OUT_CAP:
        return _retry_on_overflow(
            lambda k: inflate_v5(arrays, plan.n_bits, k, n_seg, exact=exact),
            plan.slots, probe), plan.out_size
    if use_kernels:
        out_rows = _round_pow2(
            -(-(plan.out_size + lz.BODY_START + lz.MAXLEN + 512) // 128), 64)
        m_rows = _round_pow2(-(-(plan.out_size // 3 + 130) // 128), 16)
        out2d = _retry_on_overflow(
            lambda k: inflate_v4(arrays, plan.n_bits, k, out_rows, m_rows,
                                 exact=exact), plan.slots)
        return out2d.view(-1)[lz.BODY_START:], plan.out_size
    out_pad = _round_pow2(max(plan.out_size, 1), 256)
    out = _retry_on_overflow(
        lambda k: inflate_v3(arrays, plan.n_bits, k, out_pad, exact=exact)[:2],
        plan.slots)
    return out.to(torch.int32), plan.out_size


def inflate_device(data: bytes, scanned=None, device="cuda",
                   use_kernels: bool | None = None) -> bytes:
    """Device inflate of one raw DEFLATE stream -> host bytes."""
    body, out_size = inflate_device_dev(data, scanned=scanned, device=device,
                                        use_kernels=use_kernels)
    with named_scope("dbg.readback"):
        return body[:out_size].to(torch.uint8).cpu().numpy().tobytes()


def inflate_device_long_stream(data: bytes, blocks, lengths, cells,
                               cap_rows: int | None = None, device="cuda"):
    """Decode one stream larger than the per-call run-meta cap: block-
    aligned sub-plans of bounded cell count run the flagship pipeline in
    sequence with the 32 KiB window carried on the device between calls.
    cap_rows defaults to plan.LIT_ROW_CAP.  Returns (device body int32
    (out_size,), out_size)."""
    dev = resolve_device(device)
    if cap_rows is None:
        cap_rows = _plan.LIT_ROW_CAP
    with named_scope("dbg.plan"):
        states, pends, mct = cells
        _, slots_bound = _plan.scan_extent(blocks, cells)
        cap_cells = (cap_rows * 128 // slots_bound) // (2 * TC) * TC

        # Block-aligned chunks: every block is cell-aligned on the virtual
        # layout, so per-block cell extents are known without decoding.
        ncells_b = [0 if b.btype == C.BTYPE_STORED else _block_cells(b)
                    for b in blocks]
        if max(ncells_b, default=0) > cap_cells:
            raise SingleBlockTooLarge(
                f"a single block spans {max(ncells_b)} cells (> cap {cap_cells})")
        chunks = []
        cur, cur_cells = [], 0
        for b, nc in enumerate(ncells_b):
            if cur and cur_cells + nc > cap_cells:
                chunks.append(cur)
                cur, cur_cells = [], 0
            cur.append(b)
            cur_cells += nc
        chunks.append(cur)

    with named_scope("dbg.stage"):
        tail = torch.zeros(phase_b.WINDOW, dtype=torch.int32, device=dev)
    bodies = []
    cell0 = 0
    for chunk in chunks:
        with named_scope("dbg.plan"):
            b0, b1 = chunk[0], chunk[-1] + 1
            out0 = blocks[b0].out_start
            sub_blocks = [dataclasses.replace(b, out_start=b.out_start - out0)
                          for b in blocks[b0:b1]]
            nchunk_cells = sum(ncells_b[b0:b1])
            sub_states = states[cell0 : cell0 + nchunk_cells].astype(np.int64)
            sub_states = np.where(
                sub_states >= 0, sub_states - 2 * cell0 * CELL_BITS, -1)
            sub_cells = (sub_states.astype(np.int32),
                         pends[cell0 : cell0 + nchunk_cells], mct)
            plan = build_plan_v3(data, sub_blocks, lengths[b0:b1],
                                 cells=sub_cells)
            cell0 += nchunk_cells
        body = flagship_body(stage_plan(plan, dev), tail0=tail)
        # The next chunk's 32 KiB window, carried on the device: an input
        # staged for its call.
        with named_scope("dbg.stage"):
            bodies.append(body[: plan.out_size])
            tail = torch.cat([tail, body[: plan.out_size]])[-phase_b.WINDOW:]
    with named_scope("dbg.stage"):
        out = torch.cat(bodies)
    return out, int(out.shape[0])
