"""Merged-plan batching: N independent DEFLATE streams as one device call
(the port of debigulator_tpu/parallel/merged.py).

Streams concatenate on the virtual bitstream: each stream's blocks keep
their own EOB chain (ending in TERMINAL), cells carry exact entries (or,
from the Python scan, only the pinned block starts), and output positions
are offset per stream.  DEFLATE distances only reference
a stream's own output, so the concatenated output regions stay
independent and one Phase A + Phase B pass decodes the whole batch.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch import native
from debigulator_tpu_torch.native import get_lib
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import plan as pl
from debigulator_tpu_torch.ops.scanner import (
    scan_stream_cells,
    scan_stream_records,
)

#: Merged record arrays of a plan built with records=True.
REC_KEYS = ("m_pos", "m_meta", "r_pos", "r_cell", "r_j0len", "r_lit0", "lit")


@dataclasses.dataclass
class MergedPlan:
    plan: pl.PlanV3
    out_offsets: list[int]  # per-stream start in the merged output
    out_sizes: list[int]
    #: Merged token records of the host-fed decode (records=True), else
    #: None: m_pos/m_meta (matches at merged output offsets), r_pos/r_cell/
    #: r_j0len (literal runs; r_cell in merged virtual cells), r_lit0 (each
    #: run's first literal in ``lit``), lit (every literal byte in stream
    #: order), max_cell_tokens.
    recs: dict | None = None


def build_merged_plan(streams: list[bytes], records: bool = False,
                      scanned: list | None = None) -> MergedPlan:
    """One PlanV3 over all streams.  scanned: optional per-stream
    (blocks, lengths, cells) so callers that already indexed the streams
    do not pay a second scan.

    records=True also keeps the scanner's token records, merged, for the
    host-fed decode (ops.archive.host_fed), and sets the plan's slots to
    the first of 16/32/64 that holds the densest cell (slots_exact).  The
    reference defaults to records=True, but every one of its decode paths
    passes records=False; the port's default is theirs, so the main path's
    host plan stays record-free.  Records need the native scanner: without
    it (``DBG_NO_NATIVE=1``), or with ``scanned`` given, records=True
    raises."""
    if records and (scanned is not None or native.disabled()):
        raise RuntimeError("records=True needs the native record scan "
                           "(no DBG_NO_NATIVE, no pre-scanned input)")

    # The native scans are independent ctypes calls that release the
    # interpreter lock, so they run on a thread pool.  The plan builds are
    # many small numpy calls that hold it: on a pool they contend (29
    # pooled builds took ~5x their time one after another on an H100
    # host, chip_smoke.py's host breakdown), so they run on this thread.
    recs_list = [None] * len(streams)
    if scanned is None:
        def scan(s):
            if records:
                return scan_stream_records(s, pl.CELL_BITS)
            return scan_stream_cells(s, pl.CELL_BITS)

        if len(streams) > 1 and not native.disabled():
            get_lib()  # load once before the pool
            workers = min(len(streams), max(2, os.cpu_count() or 2))
            with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                scanned = list(pool.map(scan, streams))
        else:
            scanned = [scan(s) for s in streams]
        if records:
            recs_list = [r[3] for r in scanned]
            scanned = [r[:3] for r in scanned]
    plans = [pl.build_plan_v3(s, blocks, lengths, cells=cells)
             for s, (blocks, lengths, cells) in zip(streams, scanned)]
    exact = all(p.exact_entries for p in plans)
    have_recs = records and bool(streams)

    vb_parts, cell_entry_parts, cell_pend_parts, cell_block_parts = [], [], [], []
    ll_parts = {k: [] for k in ("count", "first", "base", "aug")}
    d_parts = {k: [] for k in ("count", "first", "base", "aug")}
    bne_parts, bob_parts = [], []
    stored_pos_parts, stored_val_parts = [], []
    out_offsets, out_sizes = [], []
    bit_cursor = 0
    block_cursor = 0
    stored_cursor = 0
    out_cursor = 0
    lit_cursor = 0
    rec_parts = {k: [] for k in REC_KEYS}
    max_cell_tokens = 0
    tc_bits = pl.TC * pl.CELL_BITS

    for p, prec in zip(plans, recs_list):
        if have_recs:
            rec_parts["m_pos"].append(prec["m_pos"] + out_cursor)
            rec_parts["m_meta"].append(prec["m_meta"])
            rec_parts["r_pos"].append(prec["r_pos"] + out_cursor)
            rec_parts["r_cell"].append(prec["r_cell"]
                                       + bit_cursor // pl.CELL_BITS)
            rec_parts["r_j0len"].append(prec["r_j0len"])
            # Merged dense literal offsets: run r's literals start at the
            # prefix sum of earlier run lengths (stream order).
            rln = (prec["r_j0len"] & 0xFF).astype(np.int64)
            lit0 = np.cumsum(rln) - rln + lit_cursor
            rec_parts["r_lit0"].append(lit0.astype(np.int32))
            rec_parts["lit"].append(prec["lit_bytes"])
            lit_cursor += int(rln.sum())
            max_cell_tokens = max(max_cell_tokens, prec["max_cell_tokens"])
        # Per-stream extent: the plan's true used virtual extent (it can
        # exceed 8*len(stream) on flush-heavy streams), rounded up to whole
        # TC-cell tiles so no tile spans two streams.  Tile-tail cells are
        # empty (entry -1) and carry the stream's last block id.
        real_bits = p.used_bits
        used_bits = -(-real_bits // tc_bits) * tc_bits
        ncells = used_bits // pl.CELL_BITS
        real_cells = -(-real_bits // pl.CELL_BITS)

        def fit(a, fill, n=ncells):
            out = np.full(n, fill, a.dtype)
            m = min(len(a), n)
            out[:m] = a[:m]
            return out

        vb_parts.append(fit(p.vbytes, 0, n=used_bits // 8))
        entries = fit(p.cell_entry, -1).astype(np.int64)
        shift = entries >= 0
        entries[shift] += 2 * bit_cursor
        cell_entry_parts.append(entries)
        cell_pend_parts.append(fit(p.cell_pend, 0))
        cb_s = fit(p.cell_block, 0)
        if 0 < real_cells < ncells:
            cb_s[real_cells:] = cb_s[real_cells - 1]
        cell_block_parts.append(cb_s + block_cursor)

        ll_parts["count"].append(p.ll_count)
        ll_parts["first"].append(p.ll_first)
        ll_parts["base"].append(p.ll_base)
        ll_parts["aug"].append(p.ll_aug)
        d_parts["count"].append(p.d_count)
        d_parts["first"].append(p.d_first)
        d_parts["base"].append(p.d_base)
        d_parts["aug"].append(p.d_aug)

        bne = p.block_next_entry.astype(np.int64).copy()
        live = bne >= 0
        bne[live] += 2 * bit_cursor
        bne_parts.append(bne)
        # Compressed output accumulates through the global cumsum of cell
        # output lengths, so per-block correction is only the stored bytes.
        bob_parts.append(p.block_out_base + stored_cursor)

        if p.stored_pos.shape[0]:
            stored_pos_parts.append(p.stored_pos + out_cursor)
            stored_val_parts.append(p.stored_val)
        stored_cursor += int(p.stored_pos.shape[0])

        out_offsets.append(out_cursor)
        out_sizes.append(p.out_size)
        out_cursor += p.out_size
        bit_cursor += used_bits
        block_cursor += p.ll_count.shape[0]

    n_bits = pl._round_pow2(max(bit_cursor, pl.CELL_BITS), 1 << 10)
    vbytes = np.zeros(n_bits // 8 + 16, np.uint8)
    vb = np.concatenate(vb_parts)
    vbytes[: len(vb)] = vb
    num_cells = n_bits // pl.CELL_BITS

    def pad_cells(parts, fill):
        arr = np.concatenate(parts)
        out = np.full(num_cells, fill, arr.dtype)
        out[: len(arr)] = arr
        return out

    merged = pl.PlanV3(
        vbytes=vbytes,
        n_bits=n_bits,
        num_cells=num_cells,
        cell_block=pad_cells(
            cell_block_parts,
            int(cell_block_parts[-1][-1]) if cell_block_parts else 0,
        ).astype(np.int32),
        cell_entry=pad_cells(cell_entry_parts, -1).astype(np.int32),
        ll_count=np.concatenate(ll_parts["count"]),
        ll_first=np.concatenate(ll_parts["first"]),
        ll_base=np.concatenate(ll_parts["base"]),
        ll_aug=np.concatenate(ll_parts["aug"]),
        d_count=np.concatenate(d_parts["count"]),
        d_first=np.concatenate(d_parts["first"]),
        d_base=np.concatenate(d_parts["base"]),
        d_aug=np.concatenate(d_parts["aug"]),
        block_next_entry=np.concatenate(bne_parts).astype(np.int32),
        block_out_base=np.concatenate(bob_parts).astype(np.int32),
        first_state=plans[0].first_state if plans else pl.TERMINAL,
        out_size=out_cursor,
        stored_pos=(np.concatenate(stored_pos_parts) if stored_pos_parts
                    else np.zeros(0, np.int32)),
        stored_val=(np.concatenate(stored_val_parts) if stored_val_parts
                    else np.zeros(0, np.uint8)),
        slots=max(p.slots for p in plans) if plans else pl.DEFAULT_SLOTS,
        exact_entries=exact,
        cell_pend=pad_cells(cell_pend_parts, 0).astype(np.int32),
        slots_exact=bool(plans) and all(p.slots_exact for p in plans),
    )
    recs = None
    if have_recs:
        recs = {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
                for k, v in rec_parts.items()}
        recs["max_cell_tokens"] = max_cell_tokens
        # Exact tape capacity (token tape rows are 128 lanes, so slots must
        # divide 128): the scanner's bound makes the overflow probe moot.
        merged.slots = next(s for s in (16, 32, 64)
                            if s >= max(max_cell_tokens, 1))
        merged.slots_exact = True
    return MergedPlan(plan=merged, out_offsets=out_offsets,
                      out_sizes=out_sizes, recs=recs)


def _pad_rec_rows(a: np.ndarray, stage_rows: int) -> np.ndarray:
    """A flat record array as (rows, 128) int32, rows padded to a multiple
    of ``stage_rows`` plus two stages of slack, zero-filled (the layout the
    host-fed resolver's inputs keep)."""
    n = len(a)
    rows = -(-max(n, 1) // 128)
    rows = -(-rows // stage_rows) * stage_rows + 2 * stage_rows
    out = np.zeros(rows * 128, np.int32)
    out[:n] = a
    return out.reshape(rows, 128)


def prepare_merged(mp: MergedPlan, device="cuda"):
    """Stage a merged plan's arrays on the device once; return a zero-
    argument runner that executes the decode (device byte buffer out).

    Three branches, as in the reference: exact entries -> the flagship, or
    the v13 driver under ``DBG_PHASE_B=v13``; speculative entries (streams
    indexed by the Python scan) -> the v5 driver, whose Phase A is tensor
    ops with the entry fixpoint.

    Tape overflow is a property of the plan (slot bound against the
    densest cell), not of a call.  With the scanner's exact slots it cannot
    happen and nothing is probed; otherwise it is resolved once here, so
    the runner never reads the overflow flag back."""
    plan = mp.plan
    dev = resolve_device(device)
    n_seg = inf.n_segments(plan.out_size)
    if plan.exact_entries:
        st = inf.stage_plan(plan, dev)
        if inf.phase_b_generation() != "v13":
            def call(slots: int):
                return inf.flagship_body(st), False
        else:
            stored = {"stored_pos": st.stored_pos, "stored_val": st.stored_val}

            def call(slots: int):
                return inf.inflate_v13(st.pa, stored, slots, n_seg)
    else:
        arrays = pl.plan_arrays_v3(plan, dev)

        def call(slots: int):
            return inf.inflate_v5(arrays, plan.n_bits, slots, n_seg,
                                  exact=False)

    slots = plan.slots
    if not plan.slots_exact:
        _, overflow = call(slots)
        if bool(overflow):
            slots = pl.CELL_BITS
            _, overflow = call(slots)
            if bool(overflow):
                raise RuntimeError("tape overflow at the exact slot bound")

    def run() -> torch.Tensor:
        return call(slots)[0]

    return run


def run_merged_plan(mp: MergedPlan, device="cuda") -> torch.Tensor:
    """Run a merged plan as one device decode -> device byte buffer."""
    return prepare_merged(mp, device=device)()


def decode_merged(streams: list[bytes], device="cuda") -> list[bytes]:
    """Decode N raw DEFLATE streams in one device pass; outputs in order."""
    dev = resolve_device(device)
    mp = build_merged_plan(streams)
    if not mp.plan.exact_entries:
        raise RuntimeError("merged decode requires the native scanner")
    body = run_merged_plan(mp, device=dev)
    body = body[: mp.plan.out_size].to(torch.uint8).cpu().numpy()
    return [body[off : off + size].tobytes()
            for off, size in zip(mp.out_offsets, mp.out_sizes)]
