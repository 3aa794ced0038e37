"""LZ77 resolvers of the previous-generation decode drivers (the port of
debigulator_tpu/ops/lz77_pallas.py).

Three functions, each behind one wrapper with its plain PyTorch twin and a
launch count, with the reference's arguments:

* ``resolve_matches_v4`` (replaces ``_match_kernel_v4`` :145): applies a
  front-compacted match list in order to a buffer whose literals and
  stored bytes are already placed (driver v4).
* ``resolve_tape_v6`` (replaces ``_tape_kernel_v6`` :317): one segment of
  Phase B from the token tape: literals stored, matches resolved (drivers
  v5 and v7).
* ``resolve_ops_v13`` (replaces ``_op_kernel_v13`` :581): one segment of
  Phase B from Phase A's match, run and literal tapes (driver v13).

Buffers are (rows, 128) int32, one byte per element, as the reference
lays them out: one pad row (``PAD``), the 32 KiB window prologue, the
body, and for the segment resolvers 4 slack rows.  A segment resolver
visits cells [cell_lo, cell_hi) of the tapes; its stores are clipped to the
body [PAD + WINDOW, (rows - 4) * 128), and a match that begins before the
body is head-clipped (destination moved up, length cut, distance kept), so
its source may lie in the window prologue.  The wrappers return a new
buffer and leave ``out_init`` as it was.

The TPU kernels' (rows, 128) lane arithmetic, SMEM staging chunks, match
list caps and speculative groups of 8 answer Mosaic's constraints and are
not carried over.  On the card each resolver starts with a placement pass
over all cells (literals read no output, so any order).  The match-list
resolver then applies its matches in stream order, a warp per match,
batching the ones whose sources are already final (csrc/lz77_copy.cuh).
The segment resolvers list each cell's clipped matches instead and hand
them to the grid-wide source chase of csrc/chase.cuh: a pointer for every
match byte to the byte it copies (in a side array flagged by a bitmap, so
the buffer may hold any int32), then every body byte chased to its root,
with no stream order and no read-back between the launches.

The plain versions place literals, point every match byte at its source
byte and follow the pointers by doubling (``ptr = ptr[ptr]``) until
nothing changes.  They assume what a DEFLATE stream guarantees: match
destinations do not overlap and every source lies before its destination.
"""

from __future__ import annotations

import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.constants import TOK_MATCH_BIT
from debigulator_tpu_torch.device import plain_here as _plain_here
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops.phase_b import _expand

WINDOW = C.WINDOW_SIZE
#: Front pad of every buffer (one full row).
PAD = 128
MAXLEN = C.MAX_MATCH_LENGTH
#: Most output bytes of one ``resolve_matches_v4`` call in the reference,
#: where the whole buffer sits in VMEM.  The card does not force it; the
#: drivers keep it as the threshold between v4 and v5 so that each driver
#: sees the inputs it sees in the JAX package.
OUT_CAP = 1536 * 1024
BODY_START = PAD + WINDOW
#: Slack rows after the body of a segment buffer.
SLACK_ROWS = 4


def _scalar(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _check_i32(*tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("resolver inputs must be contiguous int32")
        if t.dim() != 2 or t.shape[1] != 128:
            raise ValueError("resolver inputs are (rows, 128) arrays")
        if t.device != tensors[0].device:
            raise ValueError("resolver inputs must share a device")


def _apply_copies_plain(out: torch.Tensor, dst, length, dist) -> None:
    """out[dst + i] = out[dst + i - dist] for every match, in stream order,
    by pointer doubling; in place on the flat buffer."""
    live = (length > 0) & (dist > 0)
    dst, length, dist = dst[live], length[live], dist[live]
    rec, off = _expand(length)
    pos = dst[rec] + off
    inb = pos < out.numel()
    pos, rec = pos[inb], rec[inb]
    ptr = torch.arange(out.numel(), device=out.device)
    ptr[pos] = (pos - dist[rec]).clamp(min=0)
    while True:
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    out.copy_(out[ptr])


# ---------------------------------------------------------------------------
# v4: compacted match list
# ---------------------------------------------------------------------------


def resolve_matches_v4_plain(out_init, pos, meta, n_matches=None):
    out = out_init.reshape(-1).clone()
    p = pos.reshape(-1).long()
    m = meta.reshape(-1).long()
    n = p.numel() if n_matches is None else min(_scalar(n_matches), p.numel())
    _apply_copies_plain(out, p[:n], m[:n] >> 16, m[:n] & 0xFFFF)
    return out.view_as(out_init)


def resolve_matches_v4(out_init, pos, meta, n_matches=None):
    """Apply matches 0..n_matches-1 of (pos, meta) to ``out_init`` in
    order: meta = len << 16 | dist, pos = destination in the buffer
    (offset by PAD + WINDOW); ``dist < len`` repeats the pattern.  Entries
    past ``n_matches`` and entries of length 0 do nothing.  Returns the
    resolved (rows, 128) buffer.

    CUDA kernel (csrc/lz77_match.cu): one CTA walks the list, 32 matches a
    batch, a warp per match; a batch ends before the first match whose
    source or destination touches an earlier member's ranges.  Bound by
    latency, not bytes: batches are serialised by ``__syncthreads``.
    """
    _check_i32(out_init, pos, meta)
    if pos.shape != meta.shape:
        raise ValueError("pos and meta must have one shape")
    n = pos.numel() if n_matches is None else min(_scalar(n_matches),
                                                  pos.numel())
    if _plain_here(out_init):
        return resolve_matches_v4_plain(out_init, pos, meta, n)
    out = out_init.clone()
    if n > 0:
        _kernels.launch("dbg_lz77_match", out, out.numel(), pos, meta, n)
        resolve_matches_v4.launches += 1
    return out


resolve_matches_v4.launches = 0


# ---------------------------------------------------------------------------
# Segment resolvers
# ---------------------------------------------------------------------------


def _segment(out_init, cell_lo, cell_hi, seg_off, cells_tot: int):
    lo, hi = _scalar(cell_lo), _scalar(cell_hi)
    lo, hi = max(lo, 0), min(hi, cells_tot)
    body_end = (out_init.shape[0] - SLACK_ROWS) * 128
    if body_end < BODY_START:
        raise ValueError("the buffer has no room for pad row, window and slack")
    return lo, max(hi, lo), BODY_START - _scalar(seg_off), body_end


def chase_state(body_end: int, device):
    """The chase's own scratch (csrc/chase.cuh): a 64-bit state (pointer,
    then value) and a bit for every body byte."""
    n_body = body_end - BODY_START
    return (torch.empty(n_body, dtype=torch.int64, device=device),
            torch.empty(-(-n_body // 32), dtype=torch.int32, device=device))


def _chase_scratch(n: int, slots: int, body_end: int, device):
    """What the placement kernel leaves for the chase, the per-cell match
    lists (position, meta) and per cell the match count, then the chase's
    own scratch (``chase_state``)."""
    return (torch.empty((2, n * slots), dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            *chase_state(body_end, device))


def _chase(entry: str, out, body_end: int, mlist, kc, n: int, slots: int,
           state, bits) -> None:
    """The chase's launch: the match records numbered across all cells by
    the inclusive prefix sums of the cells' counts, made on the card."""
    kinc = torch.cumsum(kc, 0, dtype=torch.int32)
    _kernels.launch(entry, out, body_end, mlist[0], mlist[1], kinc, n, slots,
                    state, bits)


def _clip_matches(dst, mlen, body_end: int):
    """Head and tail clip of matches at buffer positions ``dst``: the part
    before the body is dropped (destination moved up, distance kept), and
    so is the part from body_end on.  Returns (dst, length)."""
    delta = (BODY_START - dst).clamp(min=0)
    eff = (mlen - delta).clamp(min=0)
    dst = dst + delta
    return dst, torch.minimum(eff, (body_end - dst).clamp(min=0))


def tape_place_chase(out, body_end: int, tape, counts, cbase, lo: int,
                     n: int, base_adj: int, slots: int) -> None:
    """The kernels of csrc/lz77_tape.cu over cells [lo, lo + n) (n > 0) of
    a token tape, in place on ``out``: placement (literals stored, clipped
    matches listed), then the chase (a pointer for every match byte, every
    body byte chased to its root).  Two launches, nothing read back."""
    mlist, kc, state, bits = _chase_scratch(n, slots, body_end, out.device)
    _kernels.launch("dbg_lz77_tape_place", out, body_end, tape, counts, cbase,
                    lo, n, base_adj, slots, mlist[0], mlist[1], kc)
    _chase("dbg_lz77_tape_chase", out, body_end, mlist, kc, n, slots, state,
           bits)


def resolve_tape_v6_plain(out_init, tape2d, counts, cbase, cell_lo, cell_hi,
                          seg_off, slots: int):
    cells_tot = counts.numel()
    lo, hi, base_adj, body_end = _segment(out_init, cell_lo, cell_hi, seg_off,
                                          cells_tot)
    out = out_init.reshape(-1).clone()
    tok = tape2d.reshape(-1, slots)[lo:hi].long()
    cnt = counts.reshape(-1)[lo:hi].long().clamp(max=slots)
    cb = cbase.reshape(-1)[lo:hi].long() + base_adj
    valid = torch.arange(slots, device=out.device)[None, :] < cnt[:, None]
    is_m = valid & (tok >= TOK_MATCH_BIT)
    mlen = (tok >> 16) & 0x3FFF
    out_len = torch.where(is_m, mlen, valid.long())
    cur = cb[:, None] + torch.cumsum(out_len, 1) - out_len
    lit = valid & ~is_m & (cur >= BODY_START) & (cur < body_end)
    out[cur[lit]] = (tok[lit] & 0x1FF).to(torch.int32)
    dst, eff = _clip_matches(cur[is_m], mlen[is_m], body_end)
    _apply_copies_plain(out, dst, eff, tok[is_m] & 0xFFFF)
    return out.view_as(out_init)


def resolve_tape_v6(out_init, tape2d, counts, cbase, cell_lo, cell_hi,
                    seg_off, slots: int):
    """One segment of Phase B from the token tape.

    tape2d: (cells_tot * slots / 128, 128), cell-major rows of ``slots``
    tokens (literal byte, or TOK_MATCH_BIT | len << 16 | dist); counts,
    cbase: (cells_tot / 128, 128), tokens per cell and the cell's output
    offset in the whole stream.  Cells [cell_lo, cell_hi) are visited; a
    cell's first byte lands at PAD + WINDOW + cbase - seg_off.  A count
    past ``slots`` (an overflowed tape, whose result every caller discards)
    is read as ``slots``.

    CUDA kernels (csrc/lz77_tape.cu): a thread per cell stores the cell's
    literals and lists its clipped matches; then the grid-wide chase of
    csrc/chase.cuh resolves every match byte of the body to the byte at
    the root of its chain of sources (a literal, a stored byte, the window
    prologue or a byte of ``out_init``).  Two launches with nothing read
    back between them; ``out_init`` may hold any int32 values.
    """
    _check_i32(out_init, tape2d, counts, cbase)
    if slots not in (8, 16, 32, 64, 128):
        raise ValueError(f"slots must be a power of two in [8, 128], got {slots}")
    cells_tot = counts.numel()
    if cbase.numel() != cells_tot or tape2d.numel() != cells_tot * slots:
        raise ValueError("tape, counts and cbase do not cover the same cells")
    if _plain_here(out_init):
        return resolve_tape_v6_plain(out_init, tape2d, counts, cbase, cell_lo,
                                     cell_hi, seg_off, slots)
    lo, hi, base_adj, body_end = _segment(out_init, cell_lo, cell_hi, seg_off,
                                          cells_tot)
    out = out_init.clone()
    n = hi - lo
    if n:
        tape_place_chase(out, body_end, tape2d, counts, cbase, lo, n,
                         base_adj, slots)
        resolve_tape_v6.launches += 1
    return out


resolve_tape_v6.launches = 0


def resolve_ops_v13_plain(out_init, ma2d, mb2d, ra2d, rb2d, lit2d, cnt2d,
                          cbase2d, cell_lo, cell_hi, seg_off, slots: int):
    cells_tot = cnt2d.numel()
    lo, hi, base_adj, body_end = _segment(out_init, cell_lo, cell_hi, seg_off,
                                          cells_tot)
    out = out_init.reshape(-1).clone()
    dev = out.device

    def cells(t):
        return t.reshape(-1)[: cells_tot * slots].view(cells_tot, slots)[lo:hi].long()

    cnt = cnt2d.reshape(-1)[lo:hi].long()
    cb = cbase2d.reshape(-1)[lo:hi].long() + base_adj
    slot = torch.arange(slots, device=dev)[None, :]

    # Literal runs: run_len bytes of the cell's lit row from lit0 on.
    vr = slot < ((cnt >> 8) & 0xFF).clamp(max=slots)[:, None]
    rb = cells(rb2d)[vr]
    rdst = (cb[:, None] + cells(ra2d))[vr]
    rcell = torch.arange(lo, hi, device=dev)[:, None].expand(-1, slots)[vr]
    rec, off = _expand(rb & 0xFFFF)
    pos = rdst[rec] + off
    src = rcell[rec] * slots + (rb >> 16)[rec] + off
    lit = lit2d.reshape(-1)
    ok = (pos >= BODY_START) & (pos < body_end) & (src < lit.numel())
    out[pos[ok]] = lit[src[ok]]

    vm = slot < (cnt >> 16).clamp(max=slots)[:, None]
    mb = cells(mb2d)[vm]
    dst, eff = _clip_matches((cb[:, None] + cells(ma2d))[vm], mb >> 16,
                             body_end)
    _apply_copies_plain(out, dst, eff, mb & 0xFFFF)
    return out.view_as(out_init)


def resolve_ops_v13(out_init, ma2d, mb2d, ra2d, rb2d, lit2d, cnt2d, cbase2d,
                    cell_lo, cell_hi, seg_off, slots: int):
    """One segment of Phase B from Phase A's tapes (ops.phase_a.phase_a).

    ma2d, mb2d, ra2d, rb2d, lit2d: (>= cells_tot * slots / 128, 128)
    cell-major rows (record j of cell c at c * slots + j): ma = within-cell
    output offset of a match, mb = len << 16 | dist; ra = offset of a
    literal run, rb = lit0 << 16 | run_len (lit0 = the run's first slot in
    the cell's ``lit`` row).  cnt2d: (cells_tot / 128, 128) packed
    match_count << 16 | run_count << 8 | lit_count; cbase2d: the cell's
    output offset in the whole stream.  Literal values are stored as they
    are (the token resolver masks them with 0x1FF; this one does not).

    CUDA kernels (csrc/lz77_ops.cu): a thread per cell copies the cell's
    runs and lists its clipped matches; the matches then go through the
    same grid-wide chase as ``resolve_tape_v6`` (csrc/chase.cuh).  Two
    launches with nothing read back between them.
    """
    _check_i32(out_init, ma2d, mb2d, ra2d, rb2d, lit2d, cnt2d, cbase2d)
    if slots not in (8, 16, 32, 64, 128):
        raise ValueError(f"slots must be a power of two in [8, 128], got {slots}")
    cells_tot = cnt2d.numel()
    if cbase2d.numel() != cells_tot or any(
            t.numel() < cells_tot * slots
            for t in (ma2d, mb2d, ra2d, rb2d, lit2d)):
        raise ValueError("tapes, cnt and cbase do not cover the same cells")
    if _plain_here(out_init):
        return resolve_ops_v13_plain(out_init, ma2d, mb2d, ra2d, rb2d, lit2d,
                                     cnt2d, cbase2d, cell_lo, cell_hi, seg_off,
                                     slots)
    lo, hi, base_adj, body_end = _segment(out_init, cell_lo, cell_hi, seg_off,
                                          cells_tot)
    out = out_init.clone()
    n = hi - lo
    if n:
        mlist, kc, state, bits = _chase_scratch(n, slots, body_end,
                                                out.device)
        _kernels.launch("dbg_lz77_ops_place", out, body_end, ma2d, mb2d, ra2d,
                        rb2d, lit2d, lit2d.numel(), cnt2d, cbase2d, lo, n,
                        base_adj, slots, mlist[0], mlist[1], kc)
        _chase("dbg_lz77_ops_chase", out, body_end, mlist, kc, n, slots,
               state, bits)
        resolve_ops_v13.launches += 1
    return out


resolve_ops_v13.launches = 0
