"""Tensor-op Phase A: the decode graph over every bit position and the
cell-parallel chase with its speculative entry fixpoint (the port of
``build_graph_v3`` and ``chase_cells``, debigulator_tpu/ops/inflate_v3.py
:434 and :654).

The reference computes both outside any kernel, so they are plain tensor
ops here too.  They serve the decode paths that cannot use the Phase A kernels:
plans without scanner-exact entries (the Python scan gives none) and the
all-tensor-op driver ``inflate_v3``.

* ``build_graph``: for each of the ``n_bits`` positions of the virtual
  stream, the successor state and emission of a litlen symbol starting
  there and of a distance symbol starting there: ``nxt``/``meta`` over
  ``2 * n_bits`` states (state = 2 * position + mode).  The reference's
  three lookup modes (int8 one-hot matmuls against 7-bit table planes,
  direct or paged, and a gather) all compute one gather; this is the
  gather.
* ``chase_cells``: every 64-bit cell walks its chain of states from its
  entry and writes one token per slot.  Without exact entries the entry of
  cell c is the exit of cell c-1 (block starts are pinned), iterated to a
  fixpoint; one ``changed`` read-back per sweep.  The fixpoint is the
  reference's; the sweeps that reach it are fewer (see ``chase_cells``).

Token packing: literal = byte value; match = TOK_MATCH_BIT | len << 16 |
dist; empty slot = -1.
"""

from __future__ import annotations

import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.constants import (
    K_DIST,
    K_LIT,
    K_NONE,
    META_KIND_SHIFT,
    TOK_MATCH_BIT,
)
from debigulator_tpu_torch.ops.plan import CELL_BITS

CELL_STATES = 2 * CELL_BITS
_CELL_SHIFT = CELL_STATES.bit_length() - 1  # state >> _CELL_SHIFT = its cell
_LIT, _DIST = 0, 1


def _rev15(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low 15 bits."""
    x = ((x & 0x5555) << 1) | ((x & 0xAAAA) >> 1)
    x = ((x & 0x3333) << 2) | ((x & 0xCCCC) >> 2)
    x = ((x & 0x0F0F) << 4) | ((x & 0xF0F0) >> 4)
    x = ((x & 0x00FF) << 8) | ((x & 0xFF00) >> 8)
    return x >> 1


def _decode(rev2, cb, count_t, first_t, base_t, aug_flat, aug_stride: int):
    """Canonical decode at every position: (packed symbol info, code
    length), each (cells, CELL_BITS) int32.  First matching length wins; a
    position where no length matches reads as length MAX_BITS, info 0."""
    count_c = count_t[cb]  # (cells, 16): a cell belongs to one block
    first_c = first_t[cb]
    base_c = base_t[cb]
    length = torch.zeros_like(rev2)
    offset = torch.zeros_like(rev2)
    for l in range(1, C.MAX_BITS + 1):
        off_l = (rev2 >> (C.MAX_BITS - l)) - first_c[:, l : l + 1]
        ok = (off_l >= 0) & (off_l < count_c[:, l : l + 1]) & (length == 0)
        length = torch.where(ok, l, length)
        offset = torch.where(ok, base_c[:, l : l + 1] + off_l, offset)
    unmatched = length == 0
    length = torch.where(unmatched, C.MAX_BITS, length)
    idx = cb[:, None] * aug_stride + offset.clamp_(0, aug_stride - 1)
    aug = torch.where(unmatched, 0, aug_flat[idx])
    return aug, length


def build_graph(arrays: dict, n_bits: int):
    """(nxt, meta), each (2 * n_bits,) int32.

    ``nxt`` is not clipped: TERMINAL (-2) and states past the stream fall
    outside every cell's window, so the chase reads them as inactive.  The
    32-bit windows are unsigned in the reference; here they are int64
    values below 2^32."""
    num_cells = n_bits // CELL_BITS
    n_bytes = n_bits // 8
    b = arrays["vbytes"].long()
    dev = b.device
    # Bytes i..i+4 as one 40-bit value: position 8*i + s reads bits s..s+31.
    v = (b[:n_bytes] | (b[1 : n_bytes + 1] << 8) | (b[2 : n_bytes + 2] << 16)
         | (b[3 : n_bytes + 3] << 24) | (b[4 : n_bytes + 4] << 32))
    sh = torch.arange(8, device=dev)
    win = ((v[:, None] >> sh[None, :]) & 0xFFFFFFFF).reshape(
        num_cells, CELL_BITS)
    del v, b
    rev2 = _rev15(win & 0x7FFF).to(torch.int32)

    cb = arrays["cell_block"].long()
    ll_aug, ll_len = _decode(rev2, cb, arrays["ll_count"], arrays["ll_first"],
                             arrays["ll_base"], arrays["ll_aug_flat"], 288)
    d_aug, d_len = _decode(rev2, cb, arrays["d_count"], arrays["d_first"],
                           arrays["d_base"], arrays["d_aug_flat"], 32)
    del rev2

    pos = torch.arange(n_bits, device=dev, dtype=torch.int32).reshape(
        num_cells, CELL_BITS)
    bne = arrays["bne_cell"][:, None]

    # litlen mode
    lval = ll_aug & 0x1FF
    leb = (ll_aug >> 9) & 0xF
    is_len = ((ll_aug >> 13) & 1) == 1
    is_eob = ((ll_aug >> 14) & 1) == 1
    del ll_aug
    lextra = ((win >> ll_len) & ((1 << leb) - 1)).to(torch.int32)
    nxt_lit = (pos + ll_len + torch.where(is_len, leb, 0)) * 2 \
        + is_len.to(torch.int32) * _DIST
    nxt_lit = torch.where(is_eob, bne, nxt_lit)
    # lit-state meta: a literal with its byte, or kind NONE carrying the
    # pending match length of a length symbol.
    meta_lit = torch.where(
        is_len | is_eob,
        (K_NONE << META_KIND_SHIFT)
        | torch.where(is_len, (lval + lextra) << 16, 0),
        (K_LIT << META_KIND_SHIFT) | lval)
    del lval, leb, lextra, is_len, is_eob, ll_len

    # dist mode
    dbase = d_aug & 0x7FFF
    deb = (d_aug >> 15) & 0xF
    del d_aug
    dextra = ((win >> d_len) & ((1 << deb) - 1)).to(torch.int32)
    del win
    nxt_dist = (pos + d_len + deb) * 2 + _LIT
    meta_dist = (K_DIST << META_KIND_SHIFT) | (dbase + dextra)
    del pos, dbase, deb, dextra, d_len

    nxt = torch.stack([nxt_lit, nxt_dist], dim=2).reshape(-1)
    del nxt_lit, nxt_dist
    meta = torch.stack([meta_lit, meta_dist], dim=2).reshape(-1)
    return nxt, meta


def chase_cells(nxt, meta, cell_entry, n_bits: int, slots: int,
                exact: bool = False, cell_pend=None):
    """Cell-parallel chase with the exact entry fixpoint.

    Returns (tape (cells, slots) int32, overflow 0-d bool tensor, counts
    (cells,) int32, sweeps int).  tape, overflow and counts equal the
    reference's; ``sweeps`` is this function's own count and is never more
    than the reference's.  ``counts`` may exceed ``slots``: that is
    the overflow, and such a cell's tape row holds its first ``slots``
    tokens.

    The tape-writing chase runs the full CELL_BITS + 1 steps: the reference
    leaves its loop when no lane is active, which here would be a host
    read-back per step, and inactive lanes change nothing.  The fixpoint's
    chases look every 8 steps, and run only over the cells whose entry
    changed in the sweep before.
    """
    num_cells = n_bits // CELL_BITS
    dev = nxt.device
    t_nxt = nxt.reshape(num_cells, CELL_STATES)
    t_meta = meta.reshape(num_cells, CELL_STATES)
    base = torch.arange(num_cells, device=dev, dtype=torch.int32) * CELL_STATES
    cell_entry = cell_entry.to(torch.int32)
    pinned = cell_entry >= 0

    def exits(rows, s, p):
        """Exit state and pend of the cells ``rows`` entered at (s, p): the
        chase without a tape.  Only these cells' rows are gathered, and the
        loop ends once no lane is active (one read-back every 8 steps)."""
        r_nxt, r_meta, r_base = t_nxt[rows], t_meta[rows], base[rows]
        for k in range(CELL_BITS + 1):
            s_local = s - r_base
            active = (s_local >= 0) & (s_local < CELL_STATES)
            if k % 8 == 7 and not bool(active.any()):
                break
            sl = s_local.clamp(0, CELL_STATES - 1).long()[:, None]
            mt = torch.gather(r_meta, 1, sl)[:, 0]
            pd = (mt >> 16) & 0x1FF
            new_p = torch.where((mt >> META_KIND_SHIFT) == K_DIST, 0,
                                torch.where(pd > 0, pd, p))
            s = torch.where(active, torch.gather(r_nxt, 1, sl)[:, 0], s)
            p = torch.where(active, new_p, p)
        return s, p

    def chase(s, p, tape):
        cnt = torch.zeros(num_cells, dtype=torch.int32, device=dev)
        for _ in range(CELL_BITS + 1):
            s_local = s - base
            active = (s_local >= 0) & (s_local < CELL_STATES)
            # torch.gather needs an index inside the row; the mask keeps
            # the lanes that were outside it unchanged.
            sl = s_local.clamp(0, CELL_STATES - 1).long()[:, None]
            nx = torch.gather(t_nxt, 1, sl)[:, 0]
            mt = torch.gather(t_meta, 1, sl)[:, 0]
            kind = mt >> META_KIND_SHIFT
            payload = mt & 0xFFFF
            pd = (mt >> 16) & 0x1FF
            is_dist = kind == K_DIST
            em = torch.where(is_dist, TOK_MATCH_BIT | (p << 16) | payload,
                             torch.where(kind == K_LIT, payload, -1))
            new_p = torch.where(is_dist, 0, torch.where(pd > 0, pd, p))
            do_emit = active & (em >= 0)
            # Lanes that do not write go to the spare column `slots`.
            col = torch.where(do_emit & (cnt < slots), cnt, slots)
            tape.scatter_(1, col.long()[:, None], em[:, None])
            cnt = cnt + do_emit.to(torch.int32)
            s = torch.where(active, nx, s)
            p = torch.where(active, new_p, p)
        return cnt

    if exact:
        # Scanner-recorded entries: no fixpoint.  An entry of -1 marks a
        # cell where no code starts; its lane is inactive from the start.
        e_s = cell_entry
        e_p = (cell_pend.to(torch.int32) if cell_pend is not None
               else torch.zeros(num_cells, dtype=torch.int32, device=dev))
        sweeps = 0
    else:
        e_s = torch.where(pinned, cell_entry, base)
        e_p = torch.zeros(num_cells, dtype=torch.int32, device=dev)
        sweeps = 0
        idx = torch.arange(num_cells, device=dev)
        never = num_cells  # target of a state no cell ever decodes
        # Exits are kept from sweep to sweep and recomputed only for the
        # cells whose entry changed: after the first sweeps those are the
        # few cells at the head of a chain that has not resynchronised.
        xs, xp = e_s.clone(), e_p.clone()
        stale = idx
        while stale.numel() and sweeps < num_cells + 2:
            xs[stale], xp[stale] = exits(stale, e_s[stale], e_p[stale])
            ns = torch.where(pinned, cell_entry, torch.cat([e_s[:1], xs[:-1]]))
            np_ = torch.where(pinned, 0, torch.cat([e_p[:1], xp[:-1]]))
            # A cell whose new entry lies outside its window decodes
            # nothing and hands the entry on unchanged, so the cells after
            # it, up to the cell the state points into, take it at once.
            # The reference moves it one cell per sweep, which costs one
            # sweep per padding cell behind a stream's end (TERMINAL points
            # nowhere).  The equations, and so the fixpoint, are the same:
            # the first cell that is not yet right still gets its entry
            # from the cells before it, which are.
            loc = ns - base
            source = ((loc < 0) | (loc >= CELL_STATES)) & ~pinned
            event = torch.cummax(torch.where(source | pinned, idx, -1), 0).values
            prev = torch.cat([event.new_full((1,), -1), event[:-1]])
            pj = prev.clamp(min=0)
            x, x_pend = ns[pj], np_[pj]
            target = torch.where(x >= 0, (x >> _CELL_SHIFT).long(), never)
            flood = (prev >= 0) & source[pj] & (idx <= target) & ~pinned
            ns = torch.where(flood, x, ns)
            np_ = torch.where(flood, x_pend, np_)
            stale = torch.nonzero((ns != e_s) | (np_ != e_p))[:, 0]
            e_s, e_p = ns, np_
            sweeps += 1

    tape = torch.full((num_cells, slots + 1), -1, dtype=torch.int32, device=dev)
    counts = chase(e_s, e_p, tape)
    overflow = (counts > slots).any()
    return tape[:, :slots], overflow, counts, sweeps
