"""Superseded LZ77 generations: the host-fed, v14 and v1 resolvers and
the archived match-list and group resolvers (the port of
debigulator_tpu/ops/archive/lz77_generations.py, every kernel it holds).

Eight functions, each behind one wrapper with its plain PyTorch twin and a
launch count:

* ``resolve_groups_v11`` (replaces ``_group_kernel_v11`` :609): Phase B
  of the host-fed v10 decode, from the packer's groups of 8 match pieces
  (each group's loads before its stores) and the literal pieces over the
  scanner's dense literals.
* ``compact_v14`` (replaces ``_compact_kernel_v14`` :893): each cell's
  match, run and literal records moved to precomputed dense offsets.
* ``resolve_walk_v14`` (replaces ``_walk_kernel_v14`` :1015): the dense
  lists applied: literal runs, then the matches.
* ``resolve_tape_v1`` (replaces ``_lz77_kernel`` :49, the counterpart of
  ``resolve_tape_pallas`` :806): the whole token tape to bytes.
* ``resolve_matches`` and ``resolve_matches_v2`` (replace ``_match_kernel``
  :171 and ``_match_kernel_v2`` :231): a match list applied in order to a
  buffer whose literals are placed; v1's buffer has no pad row.
* ``resolve_groups_v9`` and ``resolve_groups_v10`` (replace
  ``_group_kernel_v9`` :345 and ``_group_kernel_v10`` :431): the packer's
  match groups of 8, each group's loads before its stores (v10 first
  copies its literal pieces from the dense literal bytes).

Buffers are one int32 per byte, (rows, 128), laid out as the reference's
and ops.lz77's: one pad row, the 32 KiB window prologue, the body, and 4
slack rows.  The reference walks one 512 KiB segment per kernel call and
carries the window from one call to the next because a segment must fit
its VMEM; the card holds the whole body, so ``lim``/``lims`` may hold
several consecutive segments of one body, and one call resolves them all.
The wrappers return a new buffer and leave ``out_init`` as it was.

On the card each resolver is a grid-wide pass for what reads no output
(literal pieces, literal runs, literals of the tape), then a pass that
resolves the matches, in no order, with nothing read back between the
launches.  The v1 tape hands its matches to the grid-wide source chase of
csrc/chase.cuh: a pointer for every match byte, then every body byte
chased to its root (csrc/lz77_tape.cu).  Every other resolver hands its
list to the group chase of csrc/group_chase.cuh, which keeps its TPU
kernel's groups on any list: every written byte takes the value its
source held before the piece's group, and a later slot's store wins.  The
group resolvers (rows 10a, 10g, 10h) have groups of 8 pieces
(csrc/groups_v11.cu, groups_v9.cu); the match lists (rows 10e, 10f) have
groups of one under the overlap rule, the in-order walk (csrc/
lz77_match.cu); the v14 walk (row 10c) has a group of 8 for each group
marked clean and groups of one elsewhere (csrc/walk_v14.cu).  A wrapper
adds one to its launch count in a call that launched a kernel, and
nowhere else.  The plain versions place the literals and resolve the
matches by ops.lz77.group_walk_plain (the v1 tape by
ops.lz77._apply_copies_plain).
"""

from __future__ import annotations

import torch

from debigulator_tpu_torch.constants import TOK_MATCH_BIT
from debigulator_tpu_torch.device import plain_here as _plain_here
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops import lz77 as lz
from debigulator_tpu_torch.ops.phase_b import _expand

PAD = lz.PAD
WINDOW = lz.WINDOW
BODY_START = lz.BODY_START
SLACK_ROWS = lz.SLACK_ROWS
#: Pieces per packed group (kGroup in native/dbg_native.cpp) and matches
#: per v14 clean-bit group.
V9_GROUP = 8
#: Piece-word rows per stage: the piece arrays are padded to a multiple of
#: it plus two stages (merged._pad_rec_rows).
V9_STAGE_ROWS = 16
#: Dense-list rows per stage of the reference's v14 walk: the dense lists
#: keep two stages and two rows of padding past the records.
V14_STAGE_ROWS = 8

def _lit_scratch_rows(seg_bytes: int) -> int:
    """Rows of a segment's literal window (row 0 a pad row): the literal
    array of the host-fed decode is padded by this many rows."""
    return seg_bytes // 128 + 8


def _check_i32(*tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("inputs must be contiguous int32")
        if t.device != tensors[0].device:
            raise ValueError("inputs must share a device")


def _body_end(out_init: torch.Tensor) -> int:
    if out_init.dim() != 2 or out_init.shape[1] != 128:
        raise ValueError("the buffer is a (rows, 128) array")
    body_end = (out_init.shape[0] - SLACK_ROWS) * 128
    if body_end < BODY_START:
        raise ValueError("the buffer has no room for pad row, window and slack")
    return body_end


# ---------------------------------------------------------------------------
# v11: host-fed groups
# ---------------------------------------------------------------------------


def unpack_piece_words(w0: torch.Tensor, w1: torch.Tensor):
    """(dst, len, src) of pieces packed by host_fed._pack_piece_words:
    w0 = dst_row << 16 | rp << 8 | (rp + len), w1 = q_row << 16 | r << 8 |
    (128 - r), with rp = dst & 127 and q = src - rp; segment-local.  A
    piece ends at its row's end, as the reference's one-row mask does."""
    w0, w1 = w0.long(), w1.long()
    rp = (w0 >> 8) & 127
    dst = (w0 >> 16) * 128 + rp
    return (dst, (w0 & 255).clamp(max=128) - rp,
            (w1 >> 16) * 128 + ((w1 >> 8) & 127) + rp)


def _slot_segments(lims: torch.Tensor, lo_col: int, hi_col: int, n: int):
    """Per slot of a piece list, the segment whose [lo, hi) holds it, and
    whether one does (the ranges rise with the segment index)."""
    slot = torch.arange(n, device=lims.device)
    seg = torch.searchsorted(lims[:, lo_col].contiguous(), slot,
                             right=True) - 1
    segc = seg.clamp(min=0)
    return segc, (seg >= 0) & (slot < lims[segc, hi_col])


def _v11_pieces(lims, gpos, gmeta):
    """The live match pieces of v11 piece words in slot order: (buffer
    position, length, source, group), a piece of segment k shifted by
    lims[k, 2] - lims[0, 2]."""
    n = gpos.numel()
    seg, live = _group_live(lims, 0, 1, n)
    dst, ln, src = unpack_piece_words(gpos.reshape(-1), gmeta.reshape(-1))
    live &= ln > 0
    off = (lims[:, 2] - lims[0, 2])[seg]
    group = torch.arange(n, device=gpos.device) // V9_GROUP
    return (dst + off)[live], ln[live], (src + off)[live], group[live]


def resolve_groups_v11_plain(out_init, lim, gpos, gmeta, lpos, lmeta, lit):
    lims = lim.reshape(-1, 8).long()
    out = out_init.reshape(-1).clone()
    flat_lit = lit.reshape(-1)

    seg, live = _slot_segments(lims, 3, 4, lpos.numel())
    dst, ln, src = unpack_piece_words(lpos.reshape(-1), lmeta.reshape(-1))
    live &= ln > 0
    dst = dst[live] + (lims[:, 2] - lims[0, 2])[seg[live]]
    src = src[live] - 128 + lims[seg[live], 5] * 128
    rec, o = _expand(ln[live])
    p, s = dst[rec] + o, src[rec] + o
    ok = (p >= 0) & (p < out.numel()) & (s >= 0) & (s < flat_lit.numel())
    out[p[ok]] = flat_lit[s[ok]]

    lz.group_walk_plain(out, *_v11_pieces(lims, gpos, gmeta))
    return out.view_as(out_init)


def resolve_groups_v11(out_init, lim, gpos, gmeta, lpos, lmeta, lit):
    """Resolve host-fed segments: literal pieces, then match groups.

    out_init: (rows, 128) int32, pad row + window + the segments' bodies
    one after another + 4 slack rows.  lim: (8,) or (n_seg, 8) int32 rows
    of (match slot lo, hi, segment output offset, literal slot lo, hi,
    literal row base, 0, 0); segment k's body starts ``lim[k, 2] -
    lim[0, 2]`` bytes after the first's.  gpos/gmeta, lpos/lmeta: (rows,
    128) piece words (host_fed._pack_piece_words), segment-local: a word's
    position p lands at buffer position p + that offset.  lit: (Lr, 128)
    dense literal bytes; a literal piece reads lit[src - 128 + base * 128].
    A piece ends at its 128-byte row's end.  Groups run in slot order; a
    group's pieces all load before any of them stores, a later slot's
    store winning; a source outside the buffer reads 0 and a store
    outside it is dropped.  For the packer's groups (no piece reads what
    its group writes) that is the in-order result.  The reference's
    ``seg_bytes`` argument is not taken: the offsets come from ``lim``.

    CUDA kernels (csrc/groups_v11.cu), two entries with nothing read back
    between them: a thread per literal piece; then the group chase
    (csrc/group_chase.cuh): each match slot's words unpacked in its mark
    and pointer passes, each written byte's state chased to a value, the
    last writer's value stored.  ``out_init`` may hold any int32 values.
    """
    _check_i32(out_init, lim, gpos, gmeta, lpos, lmeta, lit)
    _body_end(out_init)
    if gpos.shape != gmeta.shape or lpos.shape != lmeta.shape:
        raise ValueError("position and meta words must have one shape")
    if gpos.numel() % V9_GROUP or lim.numel() % 8 or lim.numel() == 0:
        raise ValueError("groups of 8 slots and rows of 8 limits expected")
    if _plain_here(out_init):
        return resolve_groups_v11_plain(out_init, lim, gpos, gmeta, lpos,
                                        lmeta, lit)
    out = out_init.clone()
    lims = lim.reshape(-1, 8).contiguous()
    lits = lpos.numel() > 0
    if lits:
        _kernels.launch("dbg_groups_v11_lits", out, out.numel(), lims,
                        lims.shape[0], lpos, lmeta, lpos.numel(), lit,
                        lit.numel())
    if _group_chase("dbg_groups_v11_chase", out, lims, gpos, gmeta) or lits:
        resolve_groups_v11.launches += 1
    return out


resolve_groups_v11.launches = 0


# ---------------------------------------------------------------------------
# v14: compaction once, then the dense-list walk
# ---------------------------------------------------------------------------


def _compact_counts(cnt2d: torch.Tensor, slots: int):
    c = cnt2d.reshape(-1).long()
    return ((c >> 16).clamp(max=slots), ((c >> 8) & 0xFF).clamp(max=slots),
            (c & 0xFF).clamp(max=slots))


def compact_v14_plain(ma2d, mb2d, ra2d, rb2d, lit2d, cnt2d, moff2d, roff2d,
                      loff2d, nrows: int, nrows_lit: int, slots: int):
    dev = ma2d.device
    n_cells = cnt2d.numel()
    slot = torch.arange(slots, device=dev)[None, :]
    outs = [torch.zeros(nrows * 128, dtype=torch.int32, device=dev)
            for _ in range(4)]
    lit_out = torch.zeros(nrows_lit * 128, dtype=torch.int32, device=dev)
    mc, rc, lc = _compact_counts(cnt2d, slots)

    def move(src2d, dst, count, off2d):
        valid = slot < count[:, None]
        at = off2d.reshape(-1).long()[:, None] + slot
        src = src2d.reshape(-1)[: n_cells * slots].view(n_cells, slots)
        dst[at[valid]] = src[valid]

    move(ma2d, outs[0], mc, moff2d)
    move(mb2d, outs[1], mc, moff2d)
    move(ra2d, outs[2], rc, roff2d)
    move(rb2d, outs[3], rc, roff2d)
    move(lit2d, lit_out, lc, loff2d)
    return (*(o.view(nrows, 128) for o in outs), lit_out.view(nrows_lit, 128))


def compact_v14(ma2d, mb2d, ra2d, rb2d, lit2d, cnt2d, moff2d, roff2d, loff2d,
                nrows: int, nrows_lit: int, slots: int):
    """Compact every cell's records into dense lists in one pass.

    ma2d/mb2d/ra2d/rb2d/lit2d: (cells * slots / 128, 128) cell-major
    records (record j of cell c at c * slots + j).  cnt2d: (cells / 128,
    128) packed match_count << 16 | run_count << 8 | lit_count (a count
    past ``slots``, an overflowed tape whose result every caller
    discards, is read as ``slots``).  moff2d/roff2d/loff2d: each cell's
    dense offset in the match, run and literal lists, non-decreasing with
    each cell's records ending at or before the next cell's offset (the
    exclusive prefix sums of the counts that ``resolve_segmented_v14``
    passes).  Returns (mdst, mmeta, rdst, rmeta) as (nrows, 128) and litD
    as (nrows_lit, 128), zero where no record lands.

    CUDA kernel (csrc/compact_v14.cu): a thread per cell copies its
    records to the cell's offset and zeroes any gap up to the next offset;
    a thread per four slots zeroes those before the first record and after
    the last, so every output slot is written once.
    """
    _check_i32(ma2d, mb2d, ra2d, rb2d, lit2d, cnt2d, moff2d, roff2d, loff2d)
    if slots not in (8, 16, 32, 64, 128):
        raise ValueError(f"slots must be a power of two in [8, 128], got {slots}")
    n_cells = cnt2d.numel()
    if (any(t.numel() < n_cells * slots for t in (ma2d, mb2d, ra2d, rb2d, lit2d))
            or any(t.numel() != n_cells for t in (moff2d, roff2d, loff2d))):
        raise ValueError("records, counts and offsets do not cover the same cells")
    if _plain_here(ma2d):
        return compact_v14_plain(ma2d, mb2d, ra2d, rb2d, lit2d, cnt2d, moff2d,
                                 roff2d, loff2d, nrows, nrows_lit, slots)
    dev = ma2d.device
    if not n_cells:  # nothing to compact: no launch
        return (*torch.zeros((4, nrows, 128), dtype=torch.int32, device=dev),
                torch.zeros((nrows_lit, 128), dtype=torch.int32, device=dev))
    out = torch.empty((4, nrows, 128), dtype=torch.int32, device=dev)
    lit_out = torch.empty((nrows_lit, 128), dtype=torch.int32, device=dev)
    _kernels.launch("dbg_compact_v14", ma2d, mb2d, ra2d, rb2d, lit2d,
                    cnt2d, moff2d, roff2d, loff2d, n_cells, slots,
                    out[0], out[1], out[2], out[3], nrows * 128, lit_out,
                    nrows_lit * 128)
    compact_v14.launches += 1
    return out[0], out[1], out[2], out[3], lit_out


compact_v14.launches = 0


def _walk_limits(out_init, lims):
    """(m_lo, m_hi, r_lo, r_hi, base_adj, body_end) of a walk over the
    segments of ``lims``: their record ranges joined, positions shifted so
    the first segment's body starts at BODY_START."""
    body_end = _body_end(out_init)
    rows = lims.reshape(-1, 8)
    first, last = torch.stack([rows[0], rows[-1]]).tolist()
    return (first[0], last[1], first[2], last[3], BODY_START - first[4],
            body_end)


def _v14_matches(lims, mdst, mmeta, m_lo: int, m_hi: int, base_adj: int,
                 body_end: int):
    """The dense matches [m_lo, m_hi) that write something, in slot order,
    as the card's chase reads them: (dst, length, source, group key,
    period).  A match is clipped to the body and cut at MATCH_PIECE - (dst
    & 127).  A group of 8 aligned to the dense index whose first slot has
    bit 31 set is one group (its key the first slot, not below its
    segment's first record nor below m_lo) with no wrap, a member of
    distance 0 included; every other match is its own group under the
    overlap rule, and distance 0 writes nothing."""
    flat = mmeta.reshape(-1).long()
    q = torch.arange(m_lo, max(m_hi, m_lo), device=mmeta.device)
    mm = flat[q]
    dst, eff = lz._clip_matches(mdst.reshape(-1).long()[q] + base_adj,
                                (mm >> 16) & 0x1FF, body_end)
    eff = torch.minimum(eff, lz.MATCH_PIECE - (dst & 127))
    dist = mm & 0xFFFF
    q0 = q & ~7
    clean = flat[q0] < 0
    rows = lims.reshape(-1, 8).long()
    seg = torch.searchsorted(rows[:, 0].contiguous(), q, right=True) - 1
    segc = seg.clamp(min=0)
    inseg = (seg >= 0) & (q < rows[segc, 1])
    first = torch.where(inseg, torch.maximum(q0, rows[segc, 0]), q0)
    key = torch.where(clean, first.clamp(min=m_lo), q)
    live = (eff > 0) & (clean | (dist > 0))
    return (dst[live], eff[live], (dst - dist)[live], key[live],
            torch.where(clean, eff, dist)[live])


def resolve_walk_v14_plain(out_init, lims, mdst, mmeta, rdst, rmeta, lit2d):
    m_lo, m_hi, r_lo, r_hi, base_adj, body_end = _walk_limits(out_init, lims)
    out = out_init.reshape(-1).clone()
    lit = lit2d.reshape(-1)
    rm = rmeta.reshape(-1)[r_lo:r_hi].long() & 0xFFFFFFFF
    rec, o = _expand(rm & 0x7F)
    pos = rdst.reshape(-1)[r_lo:r_hi].long()[rec] + base_adj + o
    src = (rm >> 7)[rec] + o
    ok = (pos >= BODY_START) & (pos < body_end) & (src < lit.numel())
    out[pos[ok]] = lit[src[ok]]
    lz.group_walk_plain(out, *_v14_matches(lims, mdst, mmeta, m_lo, m_hi,
                                           base_adj, body_end))
    return out.view_as(out_init)


def resolve_walk_v14(out_init, lims, mdst, mmeta, rdst, rmeta, lit2d):
    """Walk the dense lists over one body: literal runs, then matches.

    lims: (8,) or (n_seg, 8) int32 rows of (m_lo, m_hi, r_lo, r_hi,
    seg_off, lit_row0, 0, 0) for consecutive segments of one body;
    records [m_lo of the first, m_hi of the last) and likewise the runs
    are applied, a record at position p landing at BODY_START + p -
    seg_off of the first.  mdst/mmeta: dense matches (position; clean bit
    31 | len << 16 | dist); rdst/rmeta: dense runs (position; lit_flat << 7
    | run_len, the run's bytes being lit2d's flat lit_flat ...).  Stores
    are clipped to the body [BODY_START, (rows - 4) * 128); a match that
    begins before it is head-clipped.  The matches keep the reference's
    groups: a group of 8 aligned to the dense index whose first slot has
    bit 31 set loads before it stores (each member's byte d + i gets what
    d - dist + i held before the group; a later member's store wins), and
    a segment of ``lims`` that starts inside such a group starts a group
    of its own there, as the reference's call a segment does; every other
    match takes effect in order under the overlap rule, and distance 0
    does nothing.  A source outside the buffer reads 0; a length past 258
    is cut at 512 - (dst & 127).  ``lit_row0`` is the reference's VMEM
    window base: the card reads the whole literal array.  The reference's
    ``slots`` argument (its staging size) is not taken.

    CUDA kernels (csrc/walk_v14.cu), two launches with nothing read back
    between them (``walk_v14_launch``; the limits are read once before):
    a thread per run; then the group chase (csrc/group_chase.cuh), whose
    record source reads and clips each dense match and its group's clean
    bit.  ``out_init`` may hold any int32 values.
    """
    _check_i32(out_init, lims, mdst, mmeta, rdst, rmeta, lit2d)
    if mdst.numel() != mmeta.numel() or rdst.numel() != rmeta.numel():
        raise ValueError("positions and metas must have one length")
    if _plain_here(out_init):
        return resolve_walk_v14_plain(out_init, lims, mdst, mmeta, rdst,
                                      rmeta, lit2d)
    limits = _walk_limits(out_init, lims)
    out = out_init.clone()
    if walk_v14_launch(out, limits, lims, mdst, mmeta, rdst, rmeta, lit2d):
        resolve_walk_v14.launches += 1
    return out


def walk_v14_launch(out, limits, lims, mdst, mmeta, rdst, rmeta,
                    lit2d) -> bool:
    """The card's launches of ``resolve_walk_v14`` in place on ``out``,
    with its ``limits`` (``_walk_limits``): the runs, then the group chase;
    returns whether it launched.  It reads nothing back, so it replays
    from a CUDA graph."""
    m_lo, m_hi, r_lo, r_hi, base_adj, body_end = limits
    runs, chase = r_hi > r_lo, m_hi > m_lo and body_end > BODY_START
    if chase:
        lz.check_chase(m_hi - m_lo, out.numel(),
                       lz.chase_slots(lz.MATCH_PIECE))
    if runs:
        _kernels.launch("dbg_walk_v14_runs", out, body_end, base_adj, rdst,
                        rmeta, r_lo, r_hi, lit2d, lit2d.numel())
    if chase:
        rows = lims.reshape(-1, 8)
        _kernels.launch("dbg_walk_v14_chase", out, out.numel(), body_end,
                        base_adj, rows, rows.shape[0], mdst, mmeta, m_lo,
                        m_hi, *lz.group_chase_state(
                            out.numel(), m_hi - m_lo, out.device,
                            lz.MATCH_PIECE))
    return runs or chase


resolve_walk_v14.launches = 0


# ---------------------------------------------------------------------------
# v1: the whole token tape
# ---------------------------------------------------------------------------


def _cell_lengths_plain(tape, counts):
    """Output bytes of each cell's first min(count, slots) tokens."""
    slots = tape.shape[1]
    tok = tape.long()
    valid = torch.arange(slots, device=tape.device)[None, :] < \
        counts.long().clamp(max=slots)[:, None]
    return torch.where(valid & (tok >= TOK_MATCH_BIT), (tok >> 16) & 0x3FFF,
                       valid.long()).sum(1)


def _check_total(cell_len, out_size: int):
    total = int(cell_len.sum())
    if total != out_size:
        raise ValueError(f"tape output {total} != expected {out_size}")


def resolve_tape_v1_plain(tape, counts, out_size: int) -> torch.Tensor:
    cell_len = _cell_lengths_plain(tape, counts)
    _check_total(cell_len, out_size)
    rows = BODY_START // 128 + -(-out_size // 128) + SLACK_ROWS
    buf = torch.zeros((rows, 128), dtype=torch.int32, device=tape.device)
    out = lz.resolve_tape_v6_plain(buf, tape, counts,
                                   torch.cumsum(cell_len, 0) - cell_len, 0,
                                   tape.shape[0], 0, tape.shape[1])
    return out.view(-1)[BODY_START : BODY_START + out_size].to(torch.uint8)


def resolve_tape_v1(tape, counts, out_size: int) -> torch.Tensor:
    """The whole token tape to (out_size,) uint8 on the tape's device: the
    counterpart of the reference's ``resolve_tape_pallas`` (v1).

    tape: (cells, slots) int32 tokens (literal byte, or TOK_MATCH_BIT |
    len << 16 | dist); counts: (cells,) tokens per cell (tensors or numpy
    arrays) (a count past ``slots`` is read as ``slots``).  Raises
    ValueError when the tokens' output is not ``out_size`` bytes, as the
    reference does.  Streams with stored blocks need another resolver
    (stored bytes are not in the tape).  The reference chains launches of
    at most 8192 cells and 1.5 MiB of output, each with the last 32 KiB of
    the one before as its window; here one pass covers the tape with a
    zero window before it: ``resolve_tape_v6`` over the whole tape, each
    cell's first byte the sum of the lengths of the cells before it.

    CUDA kernels (csrc/lz77_tape.cu): a thread per cell sums its token
    lengths (``tape_v1_len_kernel``), an exclusive prefix sum on the card
    gives each cell's first byte, then the v6 placement and the grid-wide
    chase (csrc/chase.cuh) run over the whole tape (pad row, zero window,
    body).  Nothing is read back between the launches: the total is
    checked after the last one (stores are clipped to the body, so a tape
    of the wrong length writes nothing outside it).
    """
    tape = torch.as_tensor(tape).contiguous()
    counts = torch.as_tensor(counts).contiguous()
    if tape.dim() != 2 or counts.shape != (tape.shape[0],):
        raise ValueError("tape is (cells, slots) and counts (cells,)")
    _check_i32(tape, counts)
    if _plain_here(tape):
        return resolve_tape_v1_plain(tape, counts, out_size)
    cells, slots = tape.shape
    cell_len = torch.zeros(cells, dtype=torch.int32, device=tape.device)
    out = torch.zeros(BODY_START + out_size, dtype=torch.int32,
                      device=tape.device)
    if cells:
        _kernels.launch("dbg_lz77_tape_v1_len", tape, counts, cells, slots,
                        cell_len)
        cbase = (torch.cumsum(cell_len, 0, dtype=torch.int32)
                 - cell_len).contiguous()
        lz.tape_place_chase(out, BODY_START + out_size, tape, counts, cbase,
                            0, cells, BODY_START, slots)
        resolve_tape_v1.launches += 1
    _check_total(cell_len, out_size)
    return out[BODY_START:].to(torch.uint8)


resolve_tape_v1.launches = 0


# ---------------------------------------------------------------------------
# v1 and v2: match lists over placed literals
# ---------------------------------------------------------------------------


def _check_list(out_init, pos, meta, prologue: int) -> None:
    _check_i32(out_init, pos, meta)
    if any(t.dim() != 2 or t.shape[1] != 128 for t in (out_init, pos, meta)):
        raise ValueError("the buffer and the list are (rows, 128) arrays")
    if pos.shape != meta.shape:
        raise ValueError("pos and meta must have one shape")
    if out_init.numel() < prologue:
        raise ValueError("the buffer has no room for its window prologue")


def resolve_matches_plain(out_init, match_pos, match_meta):
    return lz.match_list_plain(out_init, match_pos, match_meta,
                               match_pos.numel())


def resolve_matches(out_init, match_pos, match_meta):
    """Apply a match list in order (v1 layout).

    out_init: (rows, 128) int32 with no pad row: the 32 KiB window
    prologue, then the body with its literals (and stored bytes) placed.
    match_pos/match_meta: (Mr, 128) int32, every row in order: the
    destination (offset by WINDOW) and len << 16 | dist; entries of length
    0 are padding.  ``dist < len`` repeats the pattern; as
    ``ops.lz77.resolve_matches_v4`` on every entry, exact on any list.
    Returns the resolved buffer.

    CUDA kernel (csrc/lz77_match.cu, ``dbg_lz77_match``, row 8's chase
    over every entry): the group chase with groups of one, nothing read
    back.
    """
    _check_list(out_init, match_pos, match_meta, WINDOW)
    if _plain_here(out_init):
        return resolve_matches_plain(out_init, match_pos, match_meta)
    out = out_init.clone()
    if match_pos.numel():
        lz.match_chase(out, match_pos, match_meta, match_pos.numel())
        resolve_matches.launches += 1
    return out


resolve_matches.launches = 0


#: The two layouts differ only in where the buffer starts.
resolve_matches_v2_plain = resolve_matches_plain


def resolve_matches_v2(out_init, match_pos, match_meta):
    """Apply a match list in order (v2 layout).

    out_init: (rows, 128) int32: row 0 the pad row, then the window
    prologue, then the body with its literals placed (the layout of
    ``ops.inflate.match_v4_inputs``).  match_pos/match_meta: (Mr, 128)
    int32, every row in order: the destination (offset by PAD + WINDOW)
    and len << 16 | dist; entries of length 0 are padding.  Returns the
    resolved buffer.

    CUDA kernel: the v1 chase (csrc/lz77_match.cu, ``dbg_lz77_match``).
    """
    _check_list(out_init, match_pos, match_meta, BODY_START)
    if _plain_here(out_init):
        return resolve_matches_v2_plain(out_init, match_pos, match_meta)
    out = out_init.clone()
    if match_pos.numel():
        lz.match_chase(out, match_pos, match_meta, match_pos.numel())
        resolve_matches_v2.launches += 1
    return out


resolve_matches_v2.launches = 0


# ---------------------------------------------------------------------------
# v9 and v10: the packer's match groups
# ---------------------------------------------------------------------------

#: Longest piece of a v9/v10 group (the packer cuts matches at 128 bytes;
#: a longer meta is read as 128).
V9_MAX_PIECE = 128


def _group_live(lims, lo_col: int, hi_col: int, n: int):
    """Per slot, its segment and whether its group's first slot lies in
    that segment's [lo, hi) (a group never spans segments)."""
    seg, live = _slot_segments(lims, lo_col, hi_col, n)
    first = torch.arange(n, device=lims.device) // V9_GROUP * V9_GROUP
    return seg[first], live[first]


def _match_pieces(lims, gpos, gmeta):
    """The live match pieces of a group list in slot order: (buffer
    position, length, distance, group).  Positions are stream-global: a
    piece at p lands at p - lims[0, 2] + BODY_START."""
    lims = lims.long()
    n = gpos.numel()
    _, live = _group_live(lims, 0, 1, n)
    m = gmeta.reshape(-1).long()
    ln = (m >> 16).clamp(max=V9_MAX_PIECE)
    live &= ln > 0
    dst = gpos.reshape(-1).long() - lims[0, 2] + BODY_START
    group = torch.arange(n, device=gpos.device) // V9_GROUP
    return dst[live], ln[live], (m & 0xFFFF)[live], group[live]


def _lit_pieces(lims, lpos, lmeta):
    """The live literal pieces in slot order: (buffer position, length,
    flat index of the first byte in the literal array)."""
    lims = lims.long()
    seg, live = _group_live(lims, 3, 4, lpos.numel())
    m = lmeta.reshape(-1).long()
    ln = m >> 20
    live &= ln > 0
    dst = lpos.reshape(-1).long() - lims[0, 2] + BODY_START
    src = lims[seg, 5] * 128 + (m & 0xFFFFF) - 128
    return dst[live], ln[live], src[live]


#: Most slots of a group chase over pieces of at most V9_MAX_PIECE bytes.
GROUP_CHASE_SLOTS = lz.chase_slots(V9_MAX_PIECE)


def _group_chase(entry: str, out, lims, gpos, gmeta) -> bool:
    """Launch a group chase entry over every slot of gpos/gmeta into
    ``out``; returns whether it launched (not for an empty list)."""
    n = gpos.numel()
    if n == 0:
        return False
    lz.check_chase(n, out.numel(), GROUP_CHASE_SLOTS)
    _kernels.launch(entry, out, out.numel(), lims, lims.shape[0], gpos, gmeta,
                    n, *lz.group_chase_state(out.numel(), n, out.device))
    return True


def _check_groups(out_init, lim, *pairs) -> None:
    _check_i32(out_init, lim, *(t for pair in pairs for t in pair))
    _body_end(out_init)
    for pos, meta in pairs:
        if pos.shape != meta.shape:
            raise ValueError("position and meta words must have one shape")
        if pos.numel() % V9_GROUP:
            raise ValueError("a piece list holds whole groups of 8 slots")
    if lim.numel() % 8 or lim.numel() == 0:
        raise ValueError("rows of 8 limits expected")


def resolve_groups_v9_plain(out_init, lim, gpos, gmeta):
    out = out_init.reshape(-1).clone()
    dst, ln, dist, grp = _match_pieces(lim.reshape(-1, 8), gpos, gmeta)
    lz.group_walk_plain(out, dst, ln, dst - dist, grp)
    return out.view_as(out_init)


def resolve_groups_v9(out_init, lim, gpos, gmeta):
    """Resolve the packer's match groups over literals already placed.

    out_init: (rows, 128) int32, pad row + window + the segments' bodies
    one after another + 4 slack rows.  lim: (8,) or (n_seg, 8) int32 rows
    of (slot lo, slot hi, segment output offset, ...); a group is resolved
    when its first slot lies in a row's [lo, hi).  gpos/gmeta: (rows, 128)
    stream-global destinations and len << 16 | dist (len <= 128; padding
    len 0), so a piece at p lands at p - lim[0, 2] + BODY_START.  Groups
    run in slot order; a group's pieces all load before any of them
    stores, a later slot's store winning; a source outside the buffer
    reads 0 and a store outside it is dropped.  For the packer's groups
    (no piece reads what its group writes) that is the in-order result.

    CUDA kernel (csrc/groups_v9.cu, ``dbg_groups_v9_chase``): the group
    chase of csrc/group_chase.cuh over the slots, nothing read back.
    """
    _check_groups(out_init, lim, (gpos, gmeta))
    if _plain_here(out_init):
        return resolve_groups_v9_plain(out_init, lim, gpos, gmeta)
    out = out_init.clone()
    if _group_chase("dbg_groups_v9_chase", out,
                    lim.reshape(-1, 8).contiguous(), gpos, gmeta):
        resolve_groups_v9.launches += 1
    return out


resolve_groups_v9.launches = 0


def resolve_groups_v10_plain(out_init, lim, gpos, gmeta, lpos, lmeta, lit):
    lims = lim.reshape(-1, 8)
    out = out_init.reshape(-1).clone()
    flat_lit = lit.reshape(-1)
    dst, ln, src = _lit_pieces(lims, lpos, lmeta)
    rec, o = _expand(ln)
    p, s = dst[rec] + o, src[rec] + o
    ok = (p >= 0) & (p < out.numel()) & (s >= 0) & (s < flat_lit.numel())
    out[p[ok]] = flat_lit[s[ok]]
    dst, ln, dist, grp = _match_pieces(lims, gpos, gmeta)
    lz.group_walk_plain(out, dst, ln, dst - dist, grp)
    return out.view_as(out_init)


def resolve_groups_v10(out_init, lim, gpos, gmeta, lpos, lmeta, lit):
    """Resolve host-fed segments: literal pieces, then the v9 match groups.

    As ``resolve_groups_v9``, and lim rows also hold (literal slot lo, hi,
    literal row base) in columns 3-5.  lpos/lmeta: (rows, 128) literal
    pieces, the stream-global destination and len << 20 | rel: the piece's
    bytes are lit[base * 128 + rel - 128 ...] (the reference's +128 is its
    scratch pad row).  Literal pieces are cut at segment boundaries only,
    so one may cross a 128-byte row; their destinations are disjoint.  One
    call resolves every segment of ``lim``: the literal pieces of all of
    them, then the match groups in slot order.  The reference's
    ``seg_bytes`` (its literal scratch size) is not taken.

    CUDA kernels (csrc/groups_v9.cu), two entries with nothing read back
    between them: a thread per literal slot, then the v9 group chase.
    """
    _check_groups(out_init, lim, (gpos, gmeta), (lpos, lmeta))
    _check_i32(out_init, lit)
    if _plain_here(out_init):
        return resolve_groups_v10_plain(out_init, lim, gpos, gmeta, lpos,
                                        lmeta, lit)
    out = out_init.clone()
    lims = lim.reshape(-1, 8).contiguous()
    launched = lpos.numel() > 0
    if launched:
        _kernels.launch("dbg_groups_v10_lits", out, out.numel(), lims,
                        lims.shape[0], lpos, lmeta, lpos.numel(), lit,
                        lit.numel())
    if _group_chase("dbg_groups_v9_chase", out, lims, gpos, gmeta) or launched:
        resolve_groups_v10.launches += 1
    return out


resolve_groups_v10.launches = 0
