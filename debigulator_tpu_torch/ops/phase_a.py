"""Phase A: per-cell Huffman decode into match, literal-run and literal
tapes.

Replaces the TPU kernel ``_phase_a13_kernel`` (debigulator_tpu/ops/
phase_a_pallas.py:480, with ``_graph_to_scratch`` :87).  For every 64-bit
cell of the plan's virtual stream it walks the cell's token chain from the
scanner-exact entry state and emits the reference's seven arrays:

* ``ma``/``mb`` (slots, cells_pad): matches, ma = within-cell output
  offset, mb = len << 16 | dist;
* ``ra``/``rb`` (slots, cells_pad): literal runs, ra = run start offset,
  rb = lit0 << 16 | run_len (lit0 = the run's first slot in ``lit``);
* ``lit`` (slots, cells_pad): the cell's literal bytes, dense;
* ``cnt`` (cells_pad,) = match_count << 16 | run_count << 8 | lit_count;
* ``outlen`` (cells_pad,) decoded bytes of the cell.

Unused slots are 0.  A run closes only when a match emits or at the end
of the chain; a length symbol alone does not close it.  EOB sends the
chain to position 127 (inactive) and a chain stops at position >= 64.

The port's inputs drop the TPU layout (table pages, int8 7-bit planes and
the f32 parameter matmul): each cell carries its block id and the per-block
tables are indexed by it directly, which also lifts the page-locality
limit of the JAX package's input packing (``build_pa_arrays``).

CUDA kernels (csrc/phase_a.cu): one launch builds every block's
first-level decode table (``decode_lut_plain`` is its plain twin), then one
thread per cell decodes its chain sequentially; the entries are exact, so
no all-positions decode graph is built.  Bound on the H100: the slot-major
tape writes (5 x slots x 4 bytes per cell, mostly zeros) dominate the
bytes moved.  A decode step reads one table word; a CTA stages the first
16 slots of its tapes in shared memory (40 KB a CTA at any slots value)
and writes each slot row's segment with 16-byte stores, so the staging
caps the cells in flight at 640 an SM (1280 at 8 slots).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.constants import (
    K_DIST,
    K_LIT,
    K_NONE,
    META_KIND_SHIFT,
    TOK_MATCH_BIT,
)
from debigulator_tpu_torch.device import plain_here as _plain_here
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops.plan import CELL_BITS, TC, PlanV3

#: Inactive chase position (any position >= CELL_BITS).
INACTIVE = 127
#: Per-block table row: ll count/first/base (48), d count/first/base (48),
#: litlen aug (288), dist aug (32).
TAB_LL, TAB_D, TAB_W = 96, 384, 416
#: First-level decode table: window bits it is indexed by (K), the
#: table kernel's own (``dbg_phase_a_lut_bits``; a test holds the two
#: equal).  The plain twin takes another K for the tests.
LUT_BITS = 9
#: A table entry: aug bits 0-19 (all the decode step reads), the code
#: length in bits 20-23, LUT_FINAL where the K bits decide the probe;
#: an undecided entry is 0.
LUT_AUG_MASK, LUT_LEN_SHIFT, LUT_FINAL = 0xFFFFF, 20, 1 << 24


@dataclasses.dataclass
class PhaseAInputs:
    """Device inputs of Phase A (and the per-cell stored offset its glue
    needs).  cells_pad = num_cells rounded up to a multiple of TC."""

    #: (4, cells_pad) int32: rows 0/1 = the cell's 64 bits, row 2 = the
    #: 32-bit lookahead, row 3 = (entry_local + 1) | pend << 9.
    cellw: torch.Tensor
    #: (cells_pad,) int32 block id of each cell.
    cell_block: torch.Tensor
    #: (nb, TAB_W) int32 per-block decode tables.
    tables: torch.Tensor
    #: (cells_pad,) int32 stored bytes before the cell's block; padding
    #: cells repeat the last real value so the glue's cbase stays monotone.
    bob_cell: torch.Tensor


def build_phase_a_inputs(plan: PlanV3) -> dict[str, np.ndarray]:
    """Host (numpy) Phase A inputs from an exact-entry plan."""
    if not plan.exact_entries:
        raise ValueError("Phase A needs scanner-exact cell entries")
    num_cells = plan.num_cells
    nb = plan.ll_count.shape[0]
    cells_pad = -(-num_cells // TC) * TC

    nbytes = num_cells * (CELL_BITS // 8)
    vb = np.zeros(nbytes + 8, np.uint8)
    vb[: min(len(plan.vbytes), nbytes + 8)] = plan.vbytes[: nbytes + 8]
    ww = vb.view("<u4")
    cellw = np.zeros((4, cells_pad), np.int32)
    cellw[0, :num_cells] = ww[0 : 2 * num_cells : 2].view(np.int32)
    cellw[1, :num_cells] = ww[1 : 2 * num_cells : 2].view(np.int32)
    cellw[2, :num_cells] = ww[2 : 2 * num_cells + 2 : 2].view(np.int32)
    entry_local = np.full(cells_pad, -1, np.int64)
    idx = np.arange(num_cells, dtype=np.int64)
    ent = plan.cell_entry.astype(np.int64)
    entry_local[:num_cells] = np.where(ent >= 0, ent - idx * 2 * CELL_BITS, -1)
    pend = np.zeros(cells_pad, np.int64)
    if plan.cell_pend is not None:
        pend[:num_cells] = plan.cell_pend
    cellw[3] = ((entry_local + 1) | (pend << 9)).astype(np.int32)

    cell_block = np.zeros(cells_pad, np.int32)
    bob = np.zeros(cells_pad, np.int32)
    if num_cells:
        cell_block[:num_cells] = plan.cell_block
        cell_block[num_cells:] = plan.cell_block[-1]
        bob[:num_cells] = plan.block_out_base[plan.cell_block]
        bob[num_cells:] = bob[num_cells - 1]
    if nb and (cell_block.min() < 0 or cell_block.max() >= nb):
        raise ValueError("cell_block out of range of the block tables")

    tables = np.zeros((max(nb, 1), TAB_W), np.int32)
    for row0, tab in ((0, plan.ll_count), (16, plan.ll_first),
                      (32, plan.ll_base), (48, plan.d_count),
                      (64, plan.d_first), (80, plan.d_base)):
        tables[:nb, row0 : row0 + 16] = tab
    tables[:nb, TAB_LL:TAB_D] = plan.ll_aug
    tables[:nb, TAB_D:TAB_W] = plan.d_aug
    return {"cellw": cellw, "cell_block": cell_block, "tables": tables,
            "bob_cell": bob}


def stage_phase_a_inputs(host: dict[str, np.ndarray],
                         device: torch.device) -> PhaseAInputs:
    return PhaseAInputs(**{k: torch.from_numpy(v).to(device)
                           for k, v in host.items()})


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _rev15(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low 15 bits (int64 in, int64 out)."""
    x = ((x & 0x5555) << 1) | ((x & 0xAAAA) >> 1)
    x = ((x & 0x3333) << 2) | ((x & 0xCCCC) >> 2)
    x = ((x & 0x0F0F) << 4) | ((x & 0xF0F0) >> 4)
    x = ((x & 0x00FF) << 8) | ((x & 0xFF00) >> 8)
    return x >> 1


def _probe(rev: torch.Tensor, par: torch.Tensor, row0: int):
    """15-length canonical probe at every position -> (length, offset,
    unmatched); par is (96, cells) of per-cell count/first/base rows."""
    lims, dls = [], []
    for l in range(1, C.MAX_BITS + 1):
        cnt = par[row0 + l]
        fst = par[row0 + 16 + l]
        bse = par[row0 + 32 + l]
        lims.append((fst + cnt) << (C.MAX_BITS - l))
        dls.append(bse - fst)
    length = torch.ones_like(rev)
    dl_acc = dls[0].expand_as(rev).clone()
    for l in range(1, C.MAX_BITS + 1):
        s = rev >= lims[l - 1]
        length += s.long()
        if l < C.MAX_BITS:
            dl_acc += torch.where(s, dls[l] - dls[l - 1], 0)
    unmatched = length > C.MAX_BITS
    length = torch.where(unmatched, C.MAX_BITS, length)
    code = rev >> (C.MAX_BITS - length)
    offset = torch.where(unmatched, 0, code + dl_acc)
    return length, offset, unmatched


def _lookup(tab_flat, cb, col0, width, offset, unmatched):
    ok = (offset >= 0) & (offset < width) & ~unmatched
    idx = cb * TAB_W + col0 + offset.clamp(0, width - 1)
    return torch.where(ok, tab_flat[idx], 0)


def _probe_mode(rev: torch.Tensor, par: torch.Tensor, tab_flat, cb,
                mode: int):
    """(length, offset, unmatched, aug) of the litlen (mode 0) or distance
    (mode 1) probe; par is (96, blocks) broadcast against rev."""
    row0, col0, width = ((0, TAB_LL, 288), (48, TAB_D, 32))[mode]
    length, offset, unmatched = _probe(rev, par, row0)
    return (length, offset, unmatched,
            _lookup(tab_flat, cb, col0, width, offset, unmatched))


def decode_lut_plain(tables: torch.Tensor, k: int = LUT_BITS) -> torch.Tensor:
    """Plain PyTorch first-level decode table: (nb, 2, 2^k) int32, entry
    [b, mode, w] for the window whose low k bits (stream order) are w.

    Those k bits are the top k bits of the reversed 15-bit code, so the
    entry covers the codes rev_lo..rev_hi sharing them.  A comparison
    rev >= lim_l of a length l <= k has one answer over that range, so the
    probe at rev_hi is the probe of every code in it when its length is
    <= k and every longer length's limit lies above rev_hi; that entry is
    LUT_FINAL | length << 20 | aug.  Any other entry is 0."""
    nb = tables.shape[0]
    dev = tables.device
    w = torch.arange(1 << k, device=dev, dtype=torch.long)
    rev_hi = (_rev15(w) | ((1 << (C.MAX_BITS - k)) - 1))[:, None]
    rev_hi = rev_hi.expand(-1, nb).contiguous()
    par = tables[:, :96].long().T
    cb = torch.arange(nb, device=dev, dtype=torch.long)
    tab_flat = tables.reshape(-1).long()
    modes = []
    for mode in (0, 1):
        length, _, unmatched, aug = _probe_mode(rev_hi, par, tab_flat, cb, mode)
        final = ~unmatched & (length <= k)
        for l in range(k + 1, C.MAX_BITS + 1):
            row = 48 * mode + l
            final &= rev_hi < ((par[row + 16] + par[row]) << (C.MAX_BITS - l))
        entry = LUT_FINAL | (length << LUT_LEN_SHIFT) | (aug & LUT_AUG_MASK)
        modes.append(torch.where(final, entry, 0).T)  # (nb, 2^k)
    return torch.stack(modes, 1).to(torch.int32)


def lut_step_plain(lut: torch.Tensor, tables: torch.Tensor, k: int,
                   blk: torch.Tensor, mode: int, win: torch.Tensor):
    """The kernels' table lookup: (length, aug bits the decode step reads,
    final) of the windows ``win`` (int64, low 15 bits used) of blocks
    ``blk`` in ``mode``, from the table entry where it is final, else from
    the canonical probe."""
    e = lut[blk, mode, win & ((1 << k) - 1)].long()
    par = tables[:, :96].long()[blk].T
    length, _, _, aug = _probe_mode(_rev15(win & 0x7FFF), par,
                                    tables.reshape(-1).long(), blk, mode)
    final = (e & LUT_FINAL) != 0
    return (torch.where(final, (e >> LUT_LEN_SHIFT) & 0xF, length),
            torch.where(final, e, aug) & LUT_AUG_MASK, final)


def _cell_graph(cellw: torch.Tensor, cell_block: torch.Tensor,
                tables: torch.Tensor):
    """The decode graph at all 64 positions of every cell (cells on the
    last axis) and each cell's start: (nxt_lit, meta_lit, nxt_dist,
    meta_dist) of shape (64, cells) and (s_pos, s_mode, pend) of shape
    (cells,), all int64.  Window and bit-reversal arithmetic is uint32 in
    the reference; here int64 with masks."""
    dev = cellw.device
    w = cellw[:3].long() & 0xFFFFFFFF
    p = torch.arange(CELL_BITS, device=dev, dtype=torch.long)[:, None]
    lo = p < 32
    a = torch.where(lo, w[0], w[1])
    b = torch.where(lo, w[1], w[2])
    r = p & 31
    win = torch.where(r > 0, (a >> r) | ((b << (32 - r)) & 0xFFFFFFFF), a)
    rev = _rev15(win & 0x7FFF)

    cb = cell_block.long()
    tab_flat = tables.reshape(-1).long()
    par = tables[:, :96].long()[cb].T  # (96, cells)

    ll_len, ll_off, ll_un = _probe(rev, par, 0)
    ll_aug = _lookup(tab_flat, cb, TAB_LL, 288, ll_off, ll_un)
    d_len, d_off, d_un = _probe(rev, par, 48)
    d_aug = _lookup(tab_flat, cb, TAB_D, 32, d_off, d_un)

    lval = ll_aug & 0x1FF
    leb = (ll_aug >> 9) & 0xF
    is_len = ((ll_aug >> 13) & 1) == 1
    is_eob = ((ll_aug >> 14) & 1) == 1
    lextra = (win >> ll_len) & ((1 << leb) - 1)
    nxt_lit = torch.where(is_eob, INACTIVE,
                          p + ll_len + torch.where(is_len, leb, 0))
    meta_lit = torch.where(
        is_len | is_eob,
        (K_NONE << META_KIND_SHIFT)
        | torch.where(is_len, (lval + lextra) << 16, 0),
        (K_LIT << META_KIND_SHIFT) | lval)
    dbase = d_aug & 0x7FFF
    deb = (d_aug >> 15) & 0xF
    dextra = (win >> d_len) & ((1 << deb) - 1)
    nxt_dist = p + d_len + deb
    meta_dist = (K_DIST << META_KIND_SHIFT) | (dbase + dextra)

    row3 = cellw[3].long()
    el = (row3 & 0xFF) - 1
    s_pos = torch.where(el >= 0, el >> 1, INACTIVE)
    s_mode = torch.where(el >= 0, el & 1, 0)
    pend = (row3 >> 9) & 0x1FF
    return (nxt_lit, meta_lit, nxt_dist, meta_dist), (s_pos, s_mode, pend)


def phase_a_plain(cellw: torch.Tensor, cell_block: torch.Tensor,
                  tables: torch.Tensor, slots: int):
    """Plain PyTorch Phase A: the decode graph at all 64 positions of
    every cell, then a 64-step chase into the match, run and literal
    tapes."""
    dev = cellw.device
    ncell = cellw.shape[1]
    (nxt_lit, meta_lit, nxt_dist, meta_dist), (s_pos, s_mode, pend) = \
        _cell_graph(cellw, cell_block, tables)
    zero = torch.zeros(ncell, dtype=torch.long, device=dev)
    mc, rc, litc, cur = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    run_dst, run_lit0, run_len = zero.clone(), zero.clone(), zero.clone()
    # One spare row takes the writes that must not land (slot >= slots).
    tapes = {k: torch.zeros(slots + 1, ncell, dtype=torch.long, device=dev)
             for k in ("ma", "mb", "ra", "rb", "lit")}

    def put(name, count, cond, val):
        row = torch.where(cond & (count < slots), count, slots)
        tapes[name].scatter_(0, row[None], val[None])

    for pp in range(CELL_BITS):
        here = s_pos == pp
        if not bool(here.any()):
            continue
        mode_b = s_mode == 1
        nx = torch.where(mode_b, nxt_dist[pp], nxt_lit[pp])
        mt = torch.where(mode_b, meta_dist[pp], meta_lit[pp])
        kind = mt >> META_KIND_SHIFT
        payload = mt & 0xFFFF
        pd = (mt >> 16) & 0x1FF
        emit_m = here & (kind == K_DIST)
        emit_l = here & (kind == K_LIT)

        do_flush = emit_m & (run_len > 0)
        put("ra", rc, do_flush, run_dst)
        put("rb", rc, do_flush, (run_lit0 << 16) | run_len)
        rc = rc + do_flush.long()
        put("ma", mc, emit_m, cur)
        put("mb", mc, emit_m, (pend << 16) | payload)
        mc = mc + emit_m.long()
        put("lit", litc, emit_l, payload)
        fresh = emit_l & (run_len == 0)
        run_dst = torch.where(fresh, cur, run_dst)
        run_lit0 = torch.where(fresh, litc, run_lit0)
        run_len = torch.where(emit_m, 0, run_len + emit_l.long())
        litc = litc + emit_l.long()
        cur = cur + torch.where(emit_m, pend, 0) + emit_l.long()

        new_pend = torch.where(kind == K_DIST, 0, torch.where(pd > 0, pd, pend))
        mo = ((kind == K_NONE) & (pd > 0)).long()
        s_pos = torch.where(here, nx, s_pos)
        s_mode = torch.where(here, torch.where(mode_b, 0, mo), s_mode)
        pend = torch.where(here, new_pend, pend)

    do_flush = run_len > 0
    put("ra", rc, do_flush, run_dst)
    put("rb", rc, do_flush, (run_lit0 << 16) | run_len)
    rc = rc + do_flush.long()

    out = [tapes[k][:slots].to(torch.int32)
           for k in ("ma", "mb", "ra", "rb", "lit")]
    cnt = ((mc << 16) | (rc << 8) | litc).to(torch.int32)
    return (*out, cnt, cur.to(torch.int32))


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _check_inputs(inputs: PhaseAInputs, slots: int):
    cellw, cell_block, tables = inputs.cellw, inputs.cell_block, inputs.tables
    if slots not in (8, 16, 32, 64, 128):
        raise ValueError(f"slots must be a power of two in [8, 128], got {slots}")
    for t in (cellw, cell_block, tables):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("Phase A inputs must be contiguous int32")
    cells_pad = cellw.shape[1]
    if (cellw.shape[0] != 4 or cell_block.shape != (cells_pad,)
            or tables.shape[1] != TAB_W or cells_pad % TC):
        raise ValueError("Phase A input shapes do not match")
    return cellw, cell_block, tables, cells_pad


def decode_lut(tables: torch.Tensor) -> torch.Tensor:
    """The first-level decode table (``decode_lut_plain``'s contract at
    ``LUT_BITS``) on the device of ``tables``: one launch of the table
    kernel on the card, sized by the bits the kernel reports."""
    if _plain_here(tables):
        return decode_lut_plain(tables)
    k = _kernels.constant("dbg_phase_a_lut_bits")
    nb = tables.shape[0]
    lut = torch.empty((nb, 2, 1 << k), dtype=torch.int32, device=tables.device)
    _kernels.launch("dbg_phase_a_lut", tables, nb, lut)
    return lut


def phase_a(inputs: PhaseAInputs, slots: int):
    """Phase A on the device of ``inputs``: the plain version for CPU
    tensors; for CUDA tensors the table kernel, then the Phase A kernel.
    Returns (ma, mb, ra, rb, lit, cnt, outlen) as the reference's
    phase_a13_pallas does."""
    cellw, cell_block, tables, cells_pad = _check_inputs(inputs, slots)
    if _plain_here(cellw):
        return phase_a_plain(cellw, cell_block, tables, slots)
    dev = cellw.device
    lut = decode_lut(tables)
    tape = torch.empty((5, slots, cells_pad), dtype=torch.int32, device=dev)
    cnt = torch.empty(cells_pad, dtype=torch.int32, device=dev)
    outlen = torch.empty(cells_pad, dtype=torch.int32, device=dev)
    _kernels.launch("dbg_phase_a", cellw, cell_block, tables, lut, cells_pad,
                    slots, tape, cnt, outlen)
    phase_a.launches += 1
    return (tape[0], tape[1], tape[2], tape[3], tape[4], cnt, outlen)


phase_a.launches = 0


# ---------------------------------------------------------------------------
# Token-tape Phase A (the v7 driver)
# ---------------------------------------------------------------------------


def phase_a_tape_plain(cellw: torch.Tensor, cell_block: torch.Tensor,
                       tables: torch.Tensor, slots: int):
    """Plain PyTorch token-tape Phase A: the same decode graph, then a
    64-position chase that writes one token per slot."""
    ncell = cellw.shape[1]
    dev = cellw.device
    (nxt_lit, meta_lit, nxt_dist, meta_dist), (s_pos, s_mode, pend) = \
        _cell_graph(cellw, cell_block, tables)
    cnt = torch.zeros(ncell, dtype=torch.long, device=dev)
    # One spare column takes the writes that must not land.
    tape = torch.full((ncell, slots + 1), -1, dtype=torch.long, device=dev)
    for pp in range(CELL_BITS):
        here = s_pos == pp
        if not bool(here.any()):
            continue
        mode_b = s_mode == 1
        nx = torch.where(mode_b, nxt_dist[pp], nxt_lit[pp])
        mt = torch.where(mode_b, meta_dist[pp], meta_lit[pp])
        kind = mt >> META_KIND_SHIFT
        payload = mt & 0xFFFF
        pd = (mt >> 16) & 0x1FF
        is_dist = kind == K_DIST
        em = torch.where(is_dist, TOK_MATCH_BIT | (pend << 16) | payload,
                         torch.where(kind == K_LIT, payload, -1))
        do_emit = here & (em >= 0)
        col = torch.where(do_emit & (cnt < slots), cnt, slots)
        tape.scatter_(1, col[:, None], em[:, None])
        cnt = cnt + do_emit.long()
        new_pend = torch.where(is_dist, 0, torch.where(pd > 0, pd, pend))
        # The next mode after a litlen symbol is "dist" iff it was a length.
        mo = ((kind == K_NONE) & (pd > 0)).long()
        s_pos = torch.where(here, nx, s_pos)
        s_mode = torch.where(here, torch.where(mode_b, 0, mo), s_mode)
        pend = torch.where(here, new_pend, pend)
    return tape[:, :slots].to(torch.int32).contiguous(), cnt.to(torch.int32)


def phase_a_tape(inputs: PhaseAInputs, slots: int):
    """Token-tape Phase A, replacing the TPU kernel ``_phase_a_kernel``
    (debigulator_tpu/ops/phase_a_pallas.py:232): (tape (cells_pad, slots)
    int32, counts (cells_pad,) int32) as the reference's phase_a_pallas
    returns them.  A token is a literal byte, or TOK_MATCH_BIT | len << 16
    | dist; slots past a cell's count are -1.  ``counts`` may exceed
    ``slots`` (the caller's overflow flag); the row then holds the first
    ``slots`` tokens.

    CUDA kernels (csrc/phase_a.cu): the table kernel, then
    ``phase_a_tape_kernel``, one thread per cell with the decode step it
    shares with ``phase_a_kernel``.  Bound on the H100 by bytes: 20 bytes
    read and ``4 * slots + 4`` written per cell.  The tape is cell-major as
    the resolvers want it, so a CTA stages the first 16 slots of its cells'
    rows in shared memory and writes its contiguous ``cells x slots``
    region with 16-byte stores.
    """
    cellw, cell_block, tables, cells_pad = _check_inputs(inputs, slots)
    if _plain_here(cellw):
        return phase_a_tape_plain(cellw, cell_block, tables, slots)
    dev = cellw.device
    lut = decode_lut(tables)
    tape = torch.empty((cells_pad, slots), dtype=torch.int32, device=dev)
    counts = torch.empty(cells_pad, dtype=torch.int32, device=dev)
    _kernels.launch("dbg_phase_a_tape", cellw, cell_block, tables, lut,
                    cells_pad, slots, tape, counts)
    phase_a_tape.launches += 1
    return tape, counts


phase_a_tape.launches = 0
