"""Superseded decode drivers: the host-fed v10 and the v14 (the port of
debigulator_tpu/ops/archive/inflate_generations.py), and the drivers of
the archived kernels that no path of the JAX package calls any more.

* ``inflate_v10`` (``_inflate_v10_jit``): the host scan's records, packed
  by host_fed.build_v9_arrays, go straight to the group resolver
  (``lz77_generations.resolve_groups_v11``); no Phase A.
* ``inflate_v14`` (``_inflate_v14_jit``): the Phase A kernel, then
  ``resolve_segmented_v14``: glue, ``compact_v14`` and
  ``resolve_walk_v14``.
* ``inflate_v9`` (``resolve_groups_segmented_v9`` of debigulator_tpu/ops/
  inflate_v3.py at commit 6555e4e, :973-1010): the scanner's literal runs
  and the stored bytes scattered with tensor ops, then the v9 group
  kernel over host_fed.build_group_arrays_v10's match groups.
* ``inflate_v10_wide``: the v10 kernel over the same packing, its literal
  pieces not split at rows (``resolve_groups_v10``, the kernel the
  reference's ``inflate_v10`` ran before commit 579264c).
* ``resolve_tape_matches_v2`` / ``_v1``: a token tape through
  ``ops.inflate.match_v4_inputs`` into the v2 match-list kernel (as
  debigulator_tpu/ops/inflate_v3.py at commit c1475b8 drove it, :677 and
  :763), or into the v1 kernel without the pad row.

The reference resolves one 512 KiB segment per kernel call in a scan that
carries the 32 KiB window; the card holds the whole body, so each driver
makes one resolver call over all segments.  The bodies equal the
reference's byte for byte.
"""

from __future__ import annotations

import torch

from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import lz77 as lz
from debigulator_tpu_torch.ops.phase_b import _expand
from debigulator_tpu_torch.ops.archive import lz77_generations as lzgen
from debigulator_tpu_torch.ops.phase_a import PhaseAInputs, phase_a
from debigulator_tpu_torch.ops.plan import SEG_BYTES


def _buffer(body: torch.Tensor, tail0=None) -> torch.Tensor:
    """(rows, 128) buffer: pad row, the window (tail0 or zeros), body,
    slack rows."""
    dev = body.device
    tail = (torch.zeros(lz.WINDOW, dtype=torch.int32, device=dev)
            if tail0 is None else tail0.reshape(-1).to(torch.int32))
    return torch.cat([torch.zeros(lz.PAD, dtype=torch.int32, device=dev),
                      tail, body,
                      torch.zeros(lz.SLACK_ROWS * 128, dtype=torch.int32,
                                  device=dev)]).view(-1, 128)


def _place_stored(body: torch.Tensor, stored_pos, stored_val) -> None:
    """Stored-block bytes into the flat body; positions past its end are
    dropped, as the reference's scatter does."""
    if stored_val.numel():
        pos = stored_pos.long()
        keep = pos < body.numel()
        body[pos[keep]] = stored_val[keep].to(torch.int32)


def _body_of(out2d: torch.Tensor, total: int) -> torch.Tensor:
    return out2d.view(-1)[lz.BODY_START : lz.BODY_START + total]


def resolve_groups_segmented_v10(v9: dict, n_seg: int, stored_pos,
                                 stored_val, tail0=None, body_init=None,
                                 seg_bytes: int | None = None):
    """Phase B of the host-fed decode: (n_seg * seg_bytes,) int32 body.

    v9: host_fed.build_piece_arrays.  tail0: optional (WINDOW // 128, 128)
    incoming window (a later shard of a split stream gets the previous
    shard's tail; zeros by default).  body_init: optional (n_seg *
    seg_bytes,) initial body (a patch round replays pieces over an earlier
    output).  One ``resolve_groups_v11`` call covers all segments."""
    seg = seg_bytes if seg_bytes is not None else SEG_BYTES
    total = n_seg * seg
    dev = v9["gpos"].device
    if body_init is None:
        body = torch.zeros(total, dtype=torch.int32, device=dev)
    else:
        body = body_init.reshape(total).to(torch.int32).clone()
    _place_stored(body, stored_pos, stored_val)
    out2d = lzgen.resolve_groups_v11(
        _buffer(body, tail0), v9["lims"], v9["gpos"], v9["gmeta"],
        v9["lpos"], v9["lmeta"], v9["lit"])
    return _body_of(out2d, total)


def inflate_v10(v9: dict, stored_pos, stored_val, n_seg: int):
    """The host-fed decode's device part: the body, (n_seg * SEG_BYTES,)
    int32, from the piece arrays and the stored bytes."""
    return resolve_groups_segmented_v10(v9, n_seg, stored_pos, stored_val)


def _excl_cumsum(x: torch.Tensor):
    c = torch.cumsum(x, 0)
    return c - x, c[-1:]


def segment_lims(cbase, cell_end, m_before, r_before, l_before, totals,
                 n_seg: int, seg_bytes: int = SEG_BYTES) -> torch.Tensor:
    """(n_seg, 8) int32 walk limits: each segment's match and run record
    ranges (the cells whose output meets the segment), its offset and its
    literal row base."""
    dev = cbase.device
    offs = torch.arange(n_seg, device=dev, dtype=cbase.dtype) * seg_bytes
    lo = torch.searchsorted(cell_end, offs, right=True)
    hi = torch.searchsorted(cbase, offs + seg_bytes)
    m_tot, r_tot, l_tot = totals
    mb = torch.cat([m_before, m_tot])
    rb = torch.cat([r_before, r_tot])
    lb = torch.cat([l_before, l_tot])
    z = torch.zeros_like(offs)
    return torch.stack([mb[lo], mb[hi], rb[lo], rb[hi], offs, lb[lo] >> 7,
                        z, z], 1).to(torch.int32)


def clean_groups(mdst: torch.Tensor, mmeta: torch.Tensor) -> torch.Tensor:
    """mmeta with bit 31 set on every member of each group of 8 that is
    clean: no member overlaps itself (dist < len) and no member's source
    meets an earlier member's destination.  The exact pairwise test of the
    reference (inflate_generations.py:152-173)."""
    gd = mdst.reshape(-1, lzgen.V9_GROUP).long()
    gm = mmeta.reshape(-1, lzgen.V9_GROUP)
    glen = (gm.long() >> 16) & 0x1FF
    gdist = gm.long() & 0xFFFF
    gsrc = gd - gdist
    clean = (gdist >= glen).all(1)
    for g in range(1, lzgen.V9_GROUP):
        for i in range(g):
            hit = ((gsrc[:, g] < gd[:, i] + glen[:, i])
                   & (gsrc[:, g] + glen[:, g] > gd[:, i])
                   & (glen[:, g] > 0) & (glen[:, i] > 0))
            clean &= ~hit
    bit = torch.where(clean, -(1 << 31), 0).to(torch.int32)
    return (gm | bit[:, None]).reshape(mmeta.shape)


def resolve_segmented_v14(ma, mb, ra, rb, lit, cnt, outlen, bob_cell,
                          n_seg: int, stored_pos, stored_val,
                          slots: int) -> torch.Tensor:
    """Phase B of v14 from Phase A's tapes ((slots, cells_pad) each):
    records globalised (match and run positions plus the cell's output
    base, run metas to dense literal addresses), each cell's dense offsets
    (exclusive cumsums of its counts), ``compact_v14``, the per-group clean
    bits, the segments' record ranges, then one ``resolve_walk_v14`` over
    the whole body.  bob_cell: (num_cells,) or (cells_pad,).  Returns the
    body, (n_seg * SEG_BYTES,) int32."""
    cells_pad = ma.shape[1]
    dev = ma.device
    if cells_pad * slots >= 1 << 24:
        raise ValueError("v14 literal addresses (lit_flat << 7) need fewer "
                         "than 2^24 literal slots")
    mc = (cnt >> 16) & 0xFF
    rc = (cnt >> 8) & 0xFF
    lc = cnt & 0xFF

    cl = outlen.long()
    bob = bob_cell.long()
    if bob.numel() < cells_pad:
        bob = torch.cat([bob, bob.new_zeros(cells_pad - bob.numel())])
    cbase = bob + torch.cumsum(cl, 0) - cl
    cell_end = cbase + cl
    m_before, m_tot = _excl_cumsum(mc.long())
    r_before, r_tot = _excl_cumsum(rc.long())
    l_before, l_tot = _excl_cumsum(lc.long())

    def rows_of(t):  # (slots, cells_pad) -> cell-major (rows, 128) int32
        return t.T.contiguous().view(-1, 128).to(torch.int32)

    def rows128(v):
        return v.to(torch.int32).contiguous().view(-1, 128)

    ma_g = ma.long() + cbase[None, :]
    ra_g = ra.long() + cbase[None, :]
    rb_g = ((l_before[None, :] + (rb.long() >> 16)) << 7) | (rb.long() & 0x7F)
    cap_rows = cells_pad * slots // 128
    mdst, mmeta, rdst, rmeta, lit_d = lzgen.compact_v14(
        rows_of(ma_g), rows_of(mb), rows_of(ra_g), rows_of(rb_g),
        rows_of(lit), rows128(cnt), rows128(m_before), rows128(r_before),
        rows128(l_before), cap_rows + 2 * lzgen.V14_STAGE_ROWS + 2,
        cap_rows + 2, slots)
    # Padding entries (meta 0) become length-0 records.
    mmeta = torch.where(mmeta == 0, 0xFFFF, mmeta).to(torch.int32)
    mmeta = clean_groups(mdst, mmeta)
    lims = segment_lims(cbase, cell_end, m_before, r_before, l_before,
                        (m_tot, r_tot, l_tot), n_seg)

    total = n_seg * SEG_BYTES
    body = torch.zeros(total, dtype=torch.int32, device=dev)
    _place_stored(body, stored_pos, stored_val)
    out2d = lzgen.resolve_walk_v14(_buffer(body), lims.contiguous(), mdst,
                                   mmeta, rdst, rmeta, lit_d)
    return _body_of(out2d, total)


def inflate_v14(pa: PhaseAInputs, arrays: dict, slots: int, n_seg: int):
    """The Phase A kernel + v14 Phase B: (body, overflow).  arrays:
    stored_pos/stored_val (plan.plan_arrays_v7); bob_cell comes from the
    Phase A inputs, as ``inflate_v7``'s does."""
    ma, mb, ra, rb, lit, cnt, outlen = phase_a(pa, slots)
    overflow = (((cnt >> 16) > slots) | (((cnt >> 8) & 0xFF) > slots)
                | ((cnt & 0xFF) > slots)).any()
    body = resolve_segmented_v14(ma, mb, ra, rb, lit, cnt, outlen,
                                 pa.bob_cell, n_seg, arrays["stored_pos"],
                                 arrays["stored_val"], slots)
    return body, overflow


def resolve_groups_segmented_v9(runs: dict, v9: dict, n_seg: int,
                                stored_pos, stored_val) -> torch.Tensor:
    """Phase B of the v9 decode: (n_seg * SEG_BYTES,) int32 body.

    runs: host_fed.literal_runs (the scanner's literal runs; in the
    reference the same bytes came from the Phase A tape); v9:
    host_fed.build_group_arrays_v10 (lims, gpos, gmeta are read).  The
    literal runs, then the stored bytes, are scattered into the body; one
    ``resolve_groups_v9`` call resolves every segment (the reference ran
    one kernel call per 512 KiB segment with the window carried)."""
    total = n_seg * SEG_BYTES
    dev = v9["gpos"].device
    body = torch.zeros(total, dtype=torch.int32, device=dev)
    rec, o = _expand(runs["len"])
    pos = runs["pos"][rec] + o
    keep = pos < total
    body[pos[keep]] = runs["lit"][(runs["lit0"][rec] + o)[keep]].to(torch.int32)
    _place_stored(body, stored_pos, stored_val)
    out2d = lzgen.resolve_groups_v9(_buffer(body), v9["lims"], v9["gpos"],
                                    v9["gmeta"])
    return _body_of(out2d, total)


def inflate_v9(runs: dict, v9: dict, stored_pos, stored_val, n_seg: int):
    """The v9 decode's device part: the body, (n_seg * SEG_BYTES,) int32,
    from the literal runs, the match groups and the stored bytes."""
    return resolve_groups_segmented_v9(runs, v9, n_seg, stored_pos,
                                       stored_val)


def inflate_v10_wide(v9: dict, stored_pos, stored_val, n_seg: int):
    """The host-fed decode through the v10 kernel: the body, (n_seg *
    SEG_BYTES,) int32.  v9: host_fed.build_group_arrays_v10.  The stored
    bytes are placed, then one ``resolve_groups_v10`` call resolves every
    segment."""
    total = n_seg * SEG_BYTES
    body = torch.zeros(total, dtype=torch.int32, device=v9["gpos"].device)
    _place_stored(body, stored_pos, stored_val)
    out2d = lzgen.resolve_groups_v10(
        _buffer(body), v9["lims"], v9["gpos"], v9["gmeta"], v9["lpos"],
        v9["lmeta"], v9["lit"])
    return _body_of(out2d, total)


def resolve_tape_matches_v2(tape, cell_block, block_out_base, out_rows: int,
                            m_rows: int, stored_pos, stored_val, tail):
    """A token tape through the v2 match-list kernel: ``ops.inflate.
    match_v4_inputs`` (literals, stored bytes and the window tail placed,
    matches compacted in order) into ``resolve_matches_v2``.  Returns the
    (out_rows, 128) buffer, pad row and window first."""
    out_init, pos, meta, _ = inf.match_v4_inputs(
        tape, cell_block, block_out_base, out_rows, m_rows, stored_pos,
        stored_val, tail)
    return lzgen.resolve_matches_v2(out_init, pos, meta)


def resolve_tape_matches_v1(tape, cell_block, block_out_base, out_rows: int,
                            m_rows: int, stored_pos, stored_val, tail):
    """The same inputs through the v1 kernel: the buffer without its pad
    row and the positions less PAD.  Returns the (out_rows - 1, 128)
    buffer, window first."""
    out_init, pos, meta, _ = inf.match_v4_inputs(
        tape, cell_block, block_out_base, out_rows, m_rows, stored_pos,
        stored_val, tail)
    return lzgen.resolve_matches(out_init[lz.PAD // 128 :], pos - lz.PAD,
                                 meta)
