"""Host plan of the flagship decode: the host half of
debigulator_tpu/ops/inflate_v3.py.

The native scanner indexes blocks; the host bit-shifts every compressed
block's payload onto a 64-bit-aligned *virtual stream*, so every 64-bit
cell belongs to one block and starts at a scanner-exact decoder entry.
Per-block canonical decode tables (count/first/base, RFC 1951 §3.2.2) and
packed per-symbol info ("aug" tables) go with it.  The plan is numpy;
``plan_arrays_v3``/``plan_arrays_v7`` and ops.phase_a stage it for the
device stages of ops.inflate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.ops.huffman import HuffmanError
from debigulator_tpu_torch.ops.inflate_ref import BlockInfo

#: Cell size in bits.
CELL_BITS = 64
#: Tape slots per cell when the scanner gives no exact bound.
DEFAULT_SLOTS = 16
#: Terminal state after the final EOB: outside every cell window.
TERMINAL = -2
#: Output segment of the Phase B glue (the reference's segment size; the
#: port's walk runs over the flat buffer, the body keeps this padding).
SEG_BYTES = 512 * 1024
#: Cells per Phase A tile / compact chunk: cells_pad is a multiple of it.
TC = 512

_LIT = 0


def _round_pow2(n: int, lo: int = 256) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class PlanV3:
    vbytes: np.ndarray  # uint8 virtual stream (aligned blocks)
    n_bits: int  # virtual bit count (static, pow2)
    num_cells: int
    # per-cell
    cell_block: np.ndarray  # (Cells,) int32
    cell_entry: np.ndarray  # (Cells,) int32 pinned entry state or -1
    # per-block stacked tables
    ll_count: np.ndarray  # (NB,16)
    ll_first: np.ndarray
    ll_base: np.ndarray
    ll_aug: np.ndarray  # (NB,288) packed sym|extra|base
    d_count: np.ndarray
    d_first: np.ndarray
    d_base: np.ndarray
    d_aug: np.ndarray  # (NB,32)
    block_next_entry: np.ndarray  # (NB,)
    block_out_base: np.ndarray  # (NB,) stored bytes before block
    first_state: int
    out_size: int
    stored_pos: np.ndarray
    stored_val: np.ndarray
    slots: int
    #: True when cell_entry/cell_pend hold exact scanner-recorded entries.
    exact_entries: bool = False
    cell_pend: np.ndarray | None = None
    #: True when `slots` is the scanner's exact per-cell token bound.
    slots_exact: bool = False
    #: Real virtual-layout extent in bits (before pow2 rounding).  It can
    #: exceed 8*len(stream): each compressed block pads to cell alignment.
    #: Merged-plan trimming must use this, never the raw byte length.
    used_bits: int = 0


def plan_from_numpy(fields: dict) -> PlanV3:
    """A PlanV3 from a dict of its fields (numpy arrays and ints), e.g.
    ``dataclasses.asdict`` of another implementation's plan."""
    kw = {}
    for f in dataclasses.fields(PlanV3):
        v = fields[f.name]
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return PlanV3(**kw)


def _make_litlen_aug_table() -> np.ndarray:
    """Per-symbol packed litlen info: bits 0-8 value (literal byte or length
    base), bits 9-12 extra-bit count, bit 13 is_len, bit 14 is_eob."""
    t = np.zeros(288, np.int32)
    t[:256] = np.arange(256)
    t[256] = 1 << 14
    t[257:286] = C.LENGTH_BASE | (C.LENGTH_EXTRA_BITS << 9) | (1 << 13)
    return t  # 286/287 reserved -> 0 (corrupt-stream garbage)


def _make_dist_aug_table() -> np.ndarray:
    """Per-symbol packed dist info: bits 0-14 base, bits 15-18 extra bits."""
    t = np.zeros(32, np.int32)
    t[:30] = C.DIST_BASE | (C.DIST_EXTRA_BITS << 15)
    return t


_LL_AUG_TABLE = _make_litlen_aug_table()
_D_AUG_TABLE = _make_dist_aug_table()


def _batch_decode_tables(lengths_list, nsym_cap: int):
    """Canonical decode tables for a list of code-length arrays, built with
    O(1) NumPy calls in all: count/first_code/index_base (nb,16), the
    (nb, nsym_cap) symbol permutation and the per-block code count."""
    nb = len(lengths_list)
    sizes = np.fromiter((len(x) for x in lengths_list), np.int64, nb)
    ids = np.repeat(np.arange(nb), sizes)
    lens = np.concatenate(lengths_list).astype(np.int64) if nb else \
        np.zeros(0, np.int64)
    if lens.size and (lens.min() < 0 or lens.max() > C.MAX_BITS):
        raise HuffmanError("code length out of range")
    count = np.bincount(ids * 16 + lens, minlength=nb * 16).reshape(nb, 16)
    count[:, 0] = 0
    first = np.zeros((nb, 16), np.int64)
    code = np.zeros(nb, np.int64)
    left = np.ones(nb, np.int64)
    for bits in range(1, C.MAX_BITS + 1):
        code = (code + count[:, bits - 1]) << 1
        first[:, bits] = code
        left = (left << 1) - count[:, bits]
        if (left < 0).any():
            raise HuffmanError(
                f"over-subscribed code at length {bits} "
                f"(block {int(np.nonzero(left < 0)[0][0])})")
    base = np.zeros((nb, 16), np.int64)
    base[:, 1:] = np.cumsum(count, axis=1)[:, :-1]

    # Symbol permutation per block: stable sort of (length, symbol) with
    # unused symbols keyed past every real length.
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pos = np.arange(len(lens)) - np.repeat(starts, sizes)
    lmat = np.full((nb, nsym_cap), C.MAX_BITS + 1, np.int64)
    lmat[ids, pos] = np.where(lens > 0, lens, C.MAX_BITS + 1)
    key = lmat * (nsym_cap + 1) + np.arange(nsym_cap)[None, :]
    syms = np.argsort(key, axis=1, kind="stable")
    ncodes = count.sum(axis=1)
    return (count.astype(np.int32), first.astype(np.int32),
            base.astype(np.int32), syms.astype(np.int64), ncodes)


def _block_cells(info: BlockInfo) -> int:
    """Cells a compressed block occupies on the virtual layout."""
    return max(1, -(-(info.end_bit - info.data_start_bit) // CELL_BITS))


def scan_extent(blocks: list[BlockInfo], cells) -> tuple[int, int]:
    """(cells, slots) that build_plan_v3 will give a scanned stream: its
    used virtual extent in cells, rounded up to whole TC-cell tiles, and
    the tape slot count for the scanner's per-cell token bound.  Lets a
    batcher size its chunks before any plan is built."""
    used = sum(_block_cells(b) for b in blocks if b.btype != C.BTYPE_STORED)
    mct = cells[2]
    slots = next(s for s in (8, 16, 32, 64, 128) if s >= max(mct, 1))
    return -(-max(used, 1) // TC) * TC, slots


def build_plan_v3(data: bytes, blocks: list[BlockInfo], block_lengths,
                  slots: int = DEFAULT_SLOTS, cells=None) -> PlanV3:
    buf = np.frombuffer(memoryview(data), np.uint8)
    src64 = np.zeros(len(buf) + 16, np.uint8)
    src64[: len(buf)] = buf

    nb = len(blocks)
    ll_count = np.zeros((nb, 16), np.int32)
    ll_first = np.zeros((nb, 16), np.int32)
    ll_base = np.zeros((nb, 16), np.int32)
    ll_aug = np.zeros((nb, 288), np.int32)
    d_count = np.zeros((nb, 16), np.int32)
    d_first = np.zeros((nb, 16), np.int32)
    d_base = np.zeros((nb, 16), np.int32)
    d_aug = np.zeros((nb, 32), np.int32)
    block_next_entry = np.zeros(nb, np.int32)
    block_out_base = np.zeros(nb, np.int32)

    stored_pos_parts, stored_val_parts = [], []
    stored_before = 0

    # --- virtual layout ---
    vbase = np.zeros(nb, np.int64)
    vb_parts = []
    cursor = 0
    comp_blocks = []
    for b, info in enumerate(blocks):
        block_out_base[b] = stored_before
        if info.btype == C.BTYPE_STORED:
            sb = info.data_start_bit // 8
            stored_pos_parts.append(
                np.arange(info.out_start, info.out_start + info.out_size,
                          dtype=np.int32)
            )
            stored_val_parts.append(buf[sb : sb + info.out_size])
            stored_before += info.out_size
            vbase[b] = -1
            continue
        comp_blocks.append(b)
        ncells = _block_cells(info)
        vbase[b] = cursor
        # Bit-shift the block payload to virtual alignment.
        sbyte = info.data_start_bit // 8
        r = info.data_start_bit % 8
        nbytes = ncells * CELL_BITS // 8
        seg = src64[sbyte : sbyte + nbytes + 1].astype(np.uint16)
        shifted = (((seg[:-1] >> r) | (seg[1:] << (8 - r))).astype(np.uint8)
                   if r else src64[sbyte : sbyte + nbytes])
        part = np.zeros(nbytes, np.uint8)
        part[: len(shifted)] = shifted[:nbytes]
        vb_parts.append(part)
        cursor += ncells * CELL_BITS

    # Decode tables for all compressed blocks, batched (one NumPy pass).
    if comp_blocks:
        cb_idx = np.asarray(comp_blocks)
        llc, llf, llb, llsym, llnc = _batch_decode_tables(
            [np.asarray(block_lengths[b][0], np.int64) for b in comp_blocks],
            288)
        dc, df, db_, dsym, dnc = _batch_decode_tables(
            [np.asarray(block_lengths[b][1], np.int64) for b in comp_blocks],
            32)
        ll_count[cb_idx] = llc
        ll_first[cb_idx] = llf
        ll_base[cb_idx] = llb
        lane = np.arange(288)[None, :]
        ll_aug[cb_idx] = np.where(lane < llnc[:, None],
                                  _LL_AUG_TABLE[llsym], 0)
        d_count[cb_idx] = dc
        d_first[cb_idx] = df
        d_base[cb_idx] = db_
        d_aug[cb_idx] = np.where(np.arange(32)[None, :] < dnc[:, None],
                                 _D_AUG_TABLE[dsym], 0)

    n_bits_used = max(cursor, CELL_BITS)
    n_bits = _round_pow2(n_bits_used, 1 << 10)
    vbytes = np.zeros(n_bits // 8 + 16, np.uint8)
    if vb_parts:
        allp = np.concatenate(vb_parts)
        vbytes[: len(allp)] = allp

    # Chain EOBs: block b -> next compressed block's entry (or TERMINAL).
    next_entry = TERMINAL
    for b in reversed(range(nb)):
        block_next_entry[b] = next_entry
        if vbase[b] >= 0:
            next_entry = int(vbase[b]) * 2 + _LIT
    first_state = next_entry

    num_cells = n_bits // CELL_BITS
    cell_block = np.zeros(num_cells, np.int32)
    cell_entry = np.full(num_cells, -1, np.int32)
    cell_pend = np.zeros(num_cells, np.int32)
    exact = False
    cells_used = 0
    for b in comp_blocks:
        ncells = _block_cells(blocks[b])
        c0 = int(vbase[b]) // CELL_BITS
        cell_block[c0 : c0 + ncells] = b
        cells_used = c0 + ncells
        cell_entry[c0] = int(vbase[b]) * 2 + _LIT
    if comp_blocks:
        # Trailing padding cells inherit the last block id (monotone).
        cell_block[cells_used:] = comp_blocks[-1]
    slots_exact = False
    if cells is not None:
        # Exact scanner-recorded entries: one per used cell; -1 = no code
        # starts in the cell (its chase stays inactive).  mct is the
        # scanner-exact tape bound (mct == 0: a token-free stream).
        states, pends, mct = cells
        slots = next(s for s in (8, 16, 32, 64, 128) if s >= max(mct, 1))
        slots_exact = True
        exact = True
        used = len(states)
        cell_entry[:used] = states.astype(np.int64)
        cell_entry[used:] = -1
        cell_pend[:used] = pends

    return PlanV3(
        vbytes=vbytes,
        n_bits=n_bits,
        num_cells=num_cells,
        cell_block=cell_block,
        cell_entry=cell_entry,
        ll_count=ll_count,
        ll_first=ll_first,
        ll_base=ll_base,
        ll_aug=ll_aug,
        d_count=d_count,
        d_first=d_first,
        d_base=d_base,
        d_aug=d_aug,
        block_next_entry=block_next_entry,
        block_out_base=block_out_base,
        first_state=first_state,
        out_size=(blocks[-1].out_start + blocks[-1].out_size) if blocks else 0,
        stored_pos=(np.concatenate(stored_pos_parts) if stored_pos_parts
                    else np.zeros(0, np.int32)),
        stored_val=(np.concatenate(stored_val_parts) if stored_val_parts
                    else np.zeros(0, np.uint8)),
        slots=slots,
        exact_entries=exact,
        cell_pend=cell_pend,
        slots_exact=slots_exact,
        used_bits=n_bits_used,
    )


def plan_arrays_v3(plan: PlanV3, device) -> dict:
    """Staged inputs of the tensor-op Phase A (ops.graph) and of the
    resolvers that follow it: the counterpart of the reference's
    ``plan_arrays_v3``, as tensors on ``device``.  ``first_state`` stays a
    Python int.  The reference's ``tile_page`` (its table-page map for the
    paged matmul lookup) has no counterpart: the port's lookup is a gather
    over all blocks' tables."""
    cell_pend = (plan.cell_pend if plan.cell_pend is not None
                 else np.zeros(plan.num_cells, np.int32))
    host = {
        "vbytes": plan.vbytes,
        "cell_block": plan.cell_block,
        "cell_entry": plan.cell_entry,
        "cell_pend": cell_pend,
        "ll_count": plan.ll_count,
        "ll_first": plan.ll_first,
        "ll_base": plan.ll_base,
        "ll_aug_flat": plan.ll_aug.reshape(-1),
        "d_count": plan.d_count,
        "d_first": plan.d_first,
        "d_base": plan.d_base,
        "d_aug_flat": plan.d_aug.reshape(-1),
        "block_next_entry": plan.block_next_entry,
        # Per-cell EOB successor and stored-bytes offset, expanded on the
        # host: (cells,) is cheap to stage.
        "bne_cell": plan.block_next_entry[plan.cell_block].astype(np.int32),
        "bob_cell": plan.block_out_base[plan.cell_block].astype(np.int32),
        "block_out_base": plan.block_out_base,
        "stored_pos": np.asarray(plan.stored_pos, np.int32),
        "stored_val": np.asarray(plan.stored_val, np.uint8),
    }
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
              for k, v in host.items()}
    arrays["first_state"] = int(plan.first_state)
    return arrays


def plan_arrays_v7(plan: PlanV3, device) -> dict:
    """The stored-block bytes alone: what the kernel-fed drivers (v7, v13)
    stage beside Phase A's own inputs."""
    return {
        "stored_pos": torch.from_numpy(
            np.asarray(plan.stored_pos, np.int32)).to(device),
        "stored_val": torch.from_numpy(
            np.asarray(plan.stored_val, np.uint8)).to(device),
    }


#: Most literal-tape rows one device call may hold: the run meta keeps the
#: row in an 18-bit field.
LIT_ROW_CAP = 1 << 18


def v15_stream_too_large(plan: PlanV3) -> bool:
    """True when one call's lit tape exceeds the run-meta lit-row field
    (LIT_ROW_CAP rows): such streams run through the long-stream chunked
    decode."""
    cells_pad = -(-plan.num_cells // TC) * TC
    return cells_pad * plan.slots // 128 > LIT_ROW_CAP
