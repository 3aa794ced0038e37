"""Device inflate entry points: the flagship pipeline of
debigulator_tpu/ops/inflate_v3.py (``flagship_body`` :1405,
``inflate_device_v3_dev``/``inflate_device_v3`` :1150-1286 and
``inflate_device_long_stream`` :1549).

Phase A (CUDA kernel) -> glue -> compact (CUDA kernel) -> walk (CUDA
kernels), leaving the decoded bytes on the device as int32 values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.native.scanner import inflate_native
from debigulator_tpu_torch.ops import phase_b
from debigulator_tpu_torch.ops import plan as _plan
from debigulator_tpu_torch.ops.phase_a import (
    PhaseAInputs,
    build_phase_a_inputs,
    phase_a,
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
    v15_stream_too_large,
)
from debigulator_tpu_torch.ops.scanner import scan_stream_cells


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
    #: (n_streams,) int32 output offset of each independent stream.
    stream_starts: torch.Tensor


def n_segments(out_size: int) -> int:
    return _round_pow2(max(1, -(-out_size // SEG_BYTES)), 1)


def stage_plan(plan: PlanV3, device: torch.device,
               stream_starts=(0,)) -> StagedPlan:
    """Stage a plan's device inputs; stream_starts are the output offsets
    of the independent streams a merged plan holds.  The plan's slot count
    must be the scanner's exact per-cell token bound, so no tape can
    overflow."""
    if not plan.slots_exact:
        raise ValueError("the plan needs the scanner's exact slot bound")
    return StagedPlan(
        pa=stage_phase_a_inputs(build_phase_a_inputs(plan), device),
        stored_pos=torch.from_numpy(
            np.asarray(plan.stored_pos, np.int32)).to(device),
        stored_val=torch.from_numpy(
            np.asarray(plan.stored_val, np.uint8)).to(device),
        slots=plan.slots,
        n_seg=n_segments(plan.out_size),
        stream_starts=torch.tensor(stream_starts, dtype=torch.int32,
                                   device=device),
    )


def flagship_body(st: StagedPlan, tail0=None) -> torch.Tensor:
    """Phase A + Phase B on a staged plan: the body, int32 one byte per
    element, n_seg*SEG_BYTES long.  tail0: the 32 KiB window before the
    body (zeros for a stream head)."""
    ma, mb, ra, rb, lit, cnt, outlen = phase_a(st.pa, st.slots)
    return phase_b.resolve(ma, mb, ra, rb, lit, cnt, outlen, st.pa.bob_cell,
                           st.n_seg, st.stored_pos, st.stored_val, st.slots,
                           tail0=tail0, stream_starts=st.stream_starts)


def inflate_device_dev(data: bytes, scanned=None, device="cuda"):
    """Device inflate of one raw DEFLATE stream, output left on the device.

    Returns (body, out_size): body is a flat int32 tensor (one byte per
    element, >= out_size long).  scanned: optional (blocks, lengths, cells)
    from scan_stream_cells, so a container codec that already indexed the
    stream does not pay a second scan.
    """
    dev = resolve_device(device)
    if scanned is not None:
        blocks, lengths, cells = scanned
    else:
        blocks, lengths, cells = scan_stream_cells(data, CELL_BITS)
    plan = build_plan_v3(data, blocks, lengths, cells=cells)
    if plan.first_state == TERMINAL:  # stored-only stream
        out = np.zeros(plan.out_size, np.int32)
        out[plan.stored_pos] = plan.stored_val
        return torch.from_numpy(out).to(dev), plan.out_size
    if v15_stream_too_large(plan):
        try:
            return inflate_device_long_stream(data, blocks, lengths, cells,
                                              device=dev)
        except SingleBlockTooLarge:
            # One unsplittable block over the cap (a single-block encode of
            # 16 MB and more): native serial inflate, staged to the device.
            out = np.frombuffer(inflate_native(data)[0], np.uint8)
            return torch.from_numpy(out.astype(np.int32)).to(dev), len(out)
    return flagship_body(stage_plan(plan, dev)), plan.out_size


def inflate_device(data: bytes, scanned=None, device="cuda") -> bytes:
    """Device inflate of one raw DEFLATE stream -> host bytes."""
    body, out_size = inflate_device_dev(data, scanned=scanned, device=device)
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

    tail = torch.zeros(phase_b.WINDOW, dtype=torch.int32, device=dev)
    bodies = []
    cell0 = 0
    for chunk in chunks:
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
        plan = build_plan_v3(data, sub_blocks, lengths[b0:b1], cells=sub_cells)
        body = flagship_body(stage_plan(plan, dev), tail0=tail)
        bodies.append(body[: plan.out_size])
        tail = torch.cat([tail, body[: plan.out_size]])[-phase_b.WINDOW:]
        cell0 += nchunk_cells
    out = torch.cat(bodies)
    return out, int(out.shape[0])
