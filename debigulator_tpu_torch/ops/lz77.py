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
not carried over.  On the card the match-list resolver hands its list to
the group chase of csrc/group_chase.cuh with groups of one
(csrc/lz77_match.cu): every match byte takes what its source holds after
every earlier slot, a later slot's store winning, on any list, with no
stream order and nothing read back.  The segment resolvers start with a
placement pass over all cells (literals read no output, so any order),
list each cell's clipped matches and hand them to the grid-wide source
chase of csrc/chase.cuh: a pointer for every match byte to the byte it
copies (in a side array flagged by a bitmap, so the buffer may hold any
int32), then every body byte chased to its root, with no stream order and
no read-back between the launches.

The plain versions of the segment resolvers place literals, point every
match byte at its source byte and follow the pointers by doubling
(``ptr = ptr[ptr]``) until nothing changes (``_apply_copies_plain``).  They
assume what a DEFLATE tape guarantees: each byte is written once and every
source lies before its destination.  The match-list resolver's plain
version is ``group_walk_plain`` with groups of one, exact on any list.
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
    """out[dst + i] = out[dst - dist + i % dist] for every match, by
    pointer doubling; in place on the flat buffer.  Equal to the in-order
    walk where each byte is written once and every source lies before its
    destination, as on the Phase A tapes of rows 3, 7, 9 and 10d; the match
    lists (rows 8, 10c, 10e, 10f) use ``group_walk_plain``."""
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


def group_walk_plain(out, dst, length, src, group, period=None) -> None:
    """Group semantics on the flat buffer, in place: pieces (dst, length,
    src) in slot order, each of length > 0, ``group`` rising (a group is a
    run of pieces with one key); byte dst + i of a piece reads byte src +
    i % period (``period`` per piece; the length where None, so nothing
    wraps).  A piece's loads see the buffer as the groups before its own
    left it, stores follow in slot order (a later one wins).  A source
    byte outside the buffer reads as 0; a store outside it is dropped.

    Every written byte is an event; an event's value is the byte its
    source held before the event's group: the last event on that byte
    from an earlier group (found by one search over events sorted by
    byte and slot), else the buffer's own byte.  The pointers are followed
    by doubling."""
    n_out = out.numel()
    rec, off = _expand(length)
    wrap = off if period is None else off % period[rec]
    p, s = dst[rec] + off, src[rec] + wrap
    first = torch.searchsorted(group, group)[rec]  # first piece of its group
    keep = (p >= 0) & (p < n_out)
    p, s, first, t = p[keep], s[keep], first[keep], rec[keep]
    e = p.numel()
    if e == 0:
        return
    span = length.numel() + 1
    key, order = torch.sort(p * span + t)
    p, s, first = p[order], s[order], first[order]
    prev = torch.searchsorted(key, s * span + first) - 1
    found = (prev >= 0) & (p[prev.clamp(min=0)] == s)
    inside = (s >= 0) & (s < n_out)
    ptr = torch.cat([
        torch.where(found, prev, torch.where(inside, e + s, e + n_out)),
        torch.arange(e, e + n_out + 1, device=out.device)])
    while True:
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    vals = torch.cat([out.new_zeros(e), out, out.new_zeros(1)])
    last = torch.ones(e, dtype=torch.bool, device=out.device)
    last[:-1] = p[1:] != p[:-1]
    out[p[last]] = vals[ptr[:e][last]]


#: Longest piece of the group chase over a match list (csrc/lz77_match.cu,
#: walk_v14.cu): a match is cut at MATCH_PIECE - (dst & 127) bytes, where
#: the TPU kernels' 4-row span ends.  Only lengths past 258, which DEFLATE
#: never makes, reach it.
MATCH_PIECE = 512


def chase_slots(piece: int) -> int:
    """Most slots of a group chase over pieces of at most ``piece`` bytes:
    a writer that is not its byte's last is named by -(slot * piece +
    offset) - 2 in a 32-bit word."""
    return (2**31 - 2) // piece


def check_chase(n_slots: int, n_out: int, most: int) -> None:
    if n_slots > most or n_out >= 2**31:
        raise ValueError(f"the group chase takes at most {most} slots and "
                         "2^31 bytes")


def group_chase_state(n_out: int, n_slots: int, device, piece: int = 128):
    """The group chase's scratch (csrc/group_chase.cuh): the last and the
    first writer of every buffer byte and its 64-bit state, the head of
    each ``piece``-byte row's list of pieces (one row more on each side)
    and each slot's link in it."""
    i32 = torch.int32
    return (torch.empty(n_out, dtype=i32, device=device),
            torch.empty(n_out, dtype=i32, device=device),
            torch.empty(n_out, dtype=torch.int64, device=device),
            torch.empty(-(-n_out // piece) + 2, dtype=i32, device=device),
            torch.empty(n_slots, dtype=i32, device=device))


def match_list_plain(out_init, pos, meta, n: int):
    """Matches 0..n-1 of (pos, meta = len << 16 | dist) applied in order to
    a copy of ``out_init``: the group walk with groups of one, each byte
    d + i of a match reading d - dist + i % dist (the overlap rule).
    Length 0 and distance 0 write nothing; a length is cut at MATCH_PIECE
    - (d & 127), as on the card."""
    out = out_init.reshape(-1).clone()
    dst = pos.reshape(-1)[:n].long()
    m = meta.reshape(-1)[:n].long()
    dist = m & 0xFFFF
    ln = torch.minimum(m >> 16, MATCH_PIECE - (dst & 127))
    live = (ln > 0) & (dist > 0)
    slot = torch.arange(dst.numel(), device=dst.device)
    group_walk_plain(out, dst[live], ln[live], (dst - dist)[live], slot[live],
                     dist[live])
    return out.view_as(out_init)


def match_chase(out, pos, meta, n: int) -> None:
    """Launch the match-list chase (``dbg_lz77_match``) over entries
    0..n-1 (n > 0) of (pos, meta) into ``out``, in place."""
    check_chase(n, out.numel(), chase_slots(MATCH_PIECE))
    _kernels.launch("dbg_lz77_match", out, out.numel(), pos, meta, n,
                    *group_chase_state(out.numel(), n, out.device,
                                       MATCH_PIECE))


# ---------------------------------------------------------------------------
# v4: compacted match list
# ---------------------------------------------------------------------------


def resolve_matches_v4_plain(out_init, pos, meta, n_matches=None):
    n = pos.numel() if n_matches is None else min(_scalar(n_matches),
                                                  pos.numel())
    return match_list_plain(out_init, pos, meta, max(n, 0))


def resolve_matches_v4(out_init, pos, meta, n_matches=None):
    """Apply matches 0..n_matches-1 of (pos, meta) to ``out_init`` in
    order: meta = len << 16 | dist, pos = destination in the buffer
    (offset by PAD + WINDOW); byte pos + i takes what byte pos - dist + i
    % dist holds after every earlier match (``dist < len`` repeats the
    pattern), and a later match's store wins, on any list.  Entries past
    ``n_matches`` and entries of length 0 or distance 0 do nothing.  A
    source outside the buffer reads 0 and a store outside it is dropped;
    a length past 258 is cut at 512 - (pos & 127).  Returns the resolved
    (rows, 128) buffer.

    CUDA kernel (csrc/lz77_match.cu): the group chase of
    csrc/group_chase.cuh with groups of one: each match byte's state
    points at its source byte's last writer before the match, every
    written byte is chased to a value and the last writer's value stored;
    no slot order, nothing read back (scratch: 16 bytes a buffer byte, a
    word a 512-byte row and a match).
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
        match_chase(out, pos, meta, n)
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
