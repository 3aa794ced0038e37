"""Host prep of the host-fed decode (the port of debigulator_tpu/ops/
archive/host_fed.py).

The record scan (ops.scanner.scan_stream_records) emits the stream's
matches, literal runs and literal bytes; the native packer
(native.scanner.pack_groups) cuts the matches into conflict-free groups of
8 pieces; here every piece, match or literal, becomes two packed words
that ``lz77_generations.resolve_groups_v11`` unpacks.  Numpy throughout,
bit-exact with the reference; the results are tensors on the caller's
device.  ``build_group_arrays_v10`` and ``literal_runs`` are the inputs of
the earlier v10 and v9 group kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.native.scanner import pack_groups
from debigulator_tpu_torch.ops import lz77 as lz
from debigulator_tpu_torch.ops.archive import lz77_generations as lzgen
from debigulator_tpu_torch.ops.plan import SEG_BYTES
from debigulator_tpu_torch.parallel.merged import MergedPlan, _pad_rec_rows


def _pack_piece_words(dst_local, length, src_local):
    """Two words per piece: w0 = dst_row << 16 | rp << 8 | (rp + len) and
    w1 = q_row << 16 | r << 8 | (128 - r), where rp = dst_local & 127, q =
    src_local - rp and r = q & 127.  Positions are segment-local (the
    segment's body starts at PAD + WINDOW); every piece must satisfy
    rp + len <= 128."""
    dst_local = np.asarray(dst_local).astype(np.int64)
    src_local = np.asarray(src_local).astype(np.int64)
    rp = dst_local & 127
    q = src_local - rp
    r = q & 127
    w0 = ((dst_local >> 7) << 16) | (rp << 8) | (rp + length)
    w1 = ((q >> 7) << 16) | (r << 8) | (128 - r)
    if (q < 0).any():
        raise ValueError("a piece's load base lies before the buffer")
    return w0.astype(np.int32), w1.astype(np.int32)


def build_v9_arrays(mp: MergedPlan, n_seg: int, device="cuda") -> dict:
    """Piece arrays of a merged plan built with records=True (see
    build_piece_arrays)."""
    if mp.recs is None:
        raise ValueError("the merged plan holds no records: build it with "
                         "build_merged_plan(streams, records=True)")
    return build_piece_arrays(mp.recs, n_seg, device=device)


def build_piece_arrays(recs: dict, n_seg: int, seg_bytes: int | None = None,
                       device="cuda") -> dict:
    """Host prep of the host-fed decode: matches packed into conflict-free
    groups of 8 (native dbg_pack_groups), literal runs cut into pieces
    over the dense literal array, every piece as two words.

    Returns {"lims": (n_seg, 8), "gpos"/"gmeta": match words, "lpos"/
    "lmeta": literal words (each (rows, 128), _pad_rec_rows), "lit":
    (Lr, 128) the literal bytes padded by one segment's literal window},
    int32 tensors on ``device``.  lims rows: match slot lo/hi, segment
    output offset, literal slot lo/hi, the literal row base of the
    segment's literal words."""
    dev = resolve_device(device)
    seg = seg_bytes if seg_bytes is not None else SEG_BYTES
    origin = lz.BODY_START  # a segment's body start in its local positions

    g_pos, g_meta, seg_lo, seg_hi = pack_groups(recs["m_pos"], recs["m_meta"],
                                                seg, n_seg)
    slot_seg = np.repeat(np.arange(n_seg, dtype=np.int64),
                         (seg_hi - seg_lo).astype(np.int64))
    if len(slot_seg) != len(g_pos):
        raise ValueError("the segments' slot ranges must cover every slot")
    m_dst_l = g_pos.astype(np.int64) - slot_seg * seg + origin
    m_len = (g_meta.astype(np.int64) >> 16) & 0xFFFF
    m_src_l = m_dst_l - (g_meta.astype(np.int64) & 0xFFFF)
    g_pos, g_meta = _pack_piece_words(m_dst_l, m_len, m_src_l)

    # Literal runs -> pieces (dst, lit0, len), split at 128-byte output rows
    # (a run is at most 64 bytes, so once; rows also split the segments),
    # then bucketed per segment, each segment's slots padded to a group.
    rln = recs["r_j0len"].astype(np.int64) & 0xFF
    dst = recs["r_pos"].astype(np.int64)
    lit0 = recs["r_lit0"].astype(np.int64)
    boundary = (dst // 128 + 1) * 128
    len_a = np.minimum(rln, boundary - dst)
    len_b = rln - len_a
    p_dst = np.stack([dst, boundary], 1).reshape(-1)
    p_lit = np.stack([lit0, lit0 + len_a], 1).reshape(-1)
    p_len = np.stack([len_a, len_b], 1).reshape(-1)
    keep = p_len > 0
    p_dst, p_lit, p_len = p_dst[keep], p_lit[keep], p_len[keep]
    # Array order is output order, so a stable bucketing keeps the literal
    # offsets rising inside each segment.
    seg_id = np.clip(p_dst // seg, 0, n_seg - 1)
    order = np.argsort(seg_id, kind="stable")
    p_dst, p_lit, p_len, seg_id = (p_dst[order], p_lit[order], p_len[order],
                                   seg_id[order])
    counts = np.bincount(seg_id, minlength=n_seg)
    padded = -(-counts // lzgen.V9_GROUP) * lzgen.V9_GROUP
    starts_in = np.concatenate([[0], np.cumsum(counts)[:-1]])
    starts_out = np.concatenate([[0], np.cumsum(padded)[:-1]])
    n_slots = int(padded.sum())
    # Padding slots: a piece of length 0 at the segment's body start.
    l_pos = np.full(n_slots, (origin >> 7) << 16, np.int32)
    l_meta = np.full(n_slots, (1 << 16) | 128, np.int32)
    lit_row_base = np.zeros(n_seg, np.int32)
    rank = np.arange(len(p_dst)) - starts_in[seg_id]
    slot = starts_out[seg_id] + rank
    if len(p_dst):
        # Each segment's literal row base; a literal word's source is
        # relative to it, plus one row.
        seg_has = counts > 0
        first_lit = np.zeros(n_seg, np.int64)
        first_lit[seg_has] = p_lit[starts_in[np.nonzero(seg_has)[0]]]
        lit_row_base = (first_lit >> 7).astype(np.int32)
        rel = p_lit - (lit_row_base.astype(np.int64)[seg_id] << 7) + 128
        w0, w1 = _pack_piece_words(p_dst - seg_id * seg + origin, p_len, rel)
        l_pos[slot] = w0
        l_meta[slot] = w1

    lims = np.zeros((n_seg, 8), np.int32)
    lims[:, 0] = seg_lo
    lims[:, 1] = seg_hi
    lims[:, 2] = (np.arange(n_seg, dtype=np.int64) * seg).astype(np.int32)
    lims[:, 3] = starts_out
    lims[:, 4] = starts_out + counts
    lims[:, 5] = lit_row_base

    lit = recs["lit"]
    lr = -(-max(len(lit), 1) // 128) + lzgen._lit_scratch_rows(seg)
    lit32 = np.zeros(lr * 128, np.int32)
    lit32[: len(lit)] = lit
    sr = lzgen.V9_STAGE_ROWS
    host = {"lims": lims, "gpos": _pad_rec_rows(g_pos, sr),
            "gmeta": _pad_rec_rows(g_meta, sr),
            "lpos": _pad_rec_rows(l_pos, sr), "lmeta": _pad_rec_rows(l_meta, sr),
            "lit": lit32.reshape(lr, 128)}
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def build_group_arrays_v10(recs: dict, n_seg: int, seg_bytes: int | None = None,
                           device="cuda") -> dict:
    """Inputs of the v10 group kernel (``lz77_generations.
    resolve_groups_v10``; v9 takes lims, gpos and gmeta): matches packed
    into conflict-free groups of 8 (native dbg_pack_groups, len <= 128),
    literal runs as pieces over the dense literal array.

    The JAX package holds no such function at HEAD: this is the packing of
    the v10 era, ``build_v9_arrays`` of debigulator_tpu/parallel/merged.py
    at the parent of commit 579264c (:211-300), which then moved the
    pieces to the row-split words of ``build_piece_arrays``.  gpos/gmeta
    are the packer's stream-global destinations and len << 16 | dist.
    Literal pieces are cut at segment boundaries only (a run is at most 64
    bytes), lpos = the destination, lmeta = len << 20 | rel with rel the
    first byte's offset from the segment's literal row base plus 128;
    padding slots hold the segment's offset and meta 0.

    Returns {"lims": (n_seg, 8) rows of (match slot lo, hi, segment
    offset, literal slot lo, hi, literal row base, 0, 0), "gpos"/"gmeta",
    "lpos"/"lmeta" ((rows, 128), _pad_rec_rows), "lit": (Lr, 128) the
    literal bytes padded by one segment's literal window}, int32 tensors on
    ``device``."""
    dev = resolve_device(device)
    seg = seg_bytes if seg_bytes is not None else SEG_BYTES
    g_pos, g_meta, seg_lo, seg_hi = pack_groups(recs["m_pos"], recs["m_meta"],
                                                seg, n_seg)

    rln = recs["r_j0len"].astype(np.int64) & 0xFF
    dst = recs["r_pos"].astype(np.int64)
    lit0 = recs["r_lit0"].astype(np.int64)
    boundary = (dst // seg + 1) * seg
    len_a = np.minimum(rln, boundary - dst)
    p_dst = np.stack([dst, boundary], 1).reshape(-1)
    p_lit = np.stack([lit0, lit0 + len_a], 1).reshape(-1)
    p_len = np.stack([len_a, rln - len_a], 1).reshape(-1)
    keep = p_len > 0
    p_dst, p_lit, p_len = p_dst[keep], p_lit[keep], p_len[keep]
    # Array order is output order, so a stable bucketing keeps the literal
    # offsets rising inside each segment.
    seg_id = np.clip(p_dst // seg, 0, n_seg - 1)
    order = np.argsort(seg_id, kind="stable")
    p_dst, p_lit, p_len, seg_id = (p_dst[order], p_lit[order], p_len[order],
                                   seg_id[order])
    counts = np.bincount(seg_id, minlength=n_seg)
    padded = -(-counts // lzgen.V9_GROUP) * lzgen.V9_GROUP
    starts_in = np.concatenate([[0], np.cumsum(counts)[:-1]])
    starts_out = np.concatenate([[0], np.cumsum(padded)[:-1]])
    n_slots = int(padded.sum())
    # Padding slots: the segment's offset, meta 0.
    l_pos = np.repeat(np.arange(n_seg, dtype=np.int64) * seg, padded)
    l_meta = np.zeros(n_slots, np.int64)
    lit_row_base = np.zeros(n_seg, np.int32)
    if len(p_dst):
        seg_has = counts > 0
        first_lit = np.zeros(n_seg, np.int64)
        first_lit[seg_has] = p_lit[starts_in[np.nonzero(seg_has)[0]]]
        lit_row_base = (first_lit >> 7).astype(np.int32)
        rel = p_lit - (lit_row_base.astype(np.int64)[seg_id] << 7) + 128
        if rel.max() >= 1 << 20:
            raise ValueError("a segment's literal slice overflows 20 bits")
        slot = starts_out[seg_id] + np.arange(len(p_dst)) - starts_in[seg_id]
        l_pos[slot] = p_dst
        l_meta[slot] = (p_len << 20) | rel

    lims = np.zeros((n_seg, 8), np.int32)
    lims[:, 0] = seg_lo
    lims[:, 1] = seg_hi
    lims[:, 2] = (np.arange(n_seg, dtype=np.int64) * seg).astype(np.int32)
    lims[:, 3] = starts_out
    lims[:, 4] = starts_out + counts
    lims[:, 5] = lit_row_base

    lit = recs["lit"]
    lr = -(-max(len(lit), 1) // 128) + lzgen._lit_scratch_rows(seg)
    lit32 = np.zeros(lr * 128, np.int32)
    lit32[: len(lit)] = lit
    sr = lzgen.V9_STAGE_ROWS
    host = {"lims": lims, "gpos": _pad_rec_rows(g_pos, sr),
            "gmeta": _pad_rec_rows(g_meta, sr),
            "lpos": _pad_rec_rows(l_pos.astype(np.int32), sr),
            "lmeta": _pad_rec_rows(l_meta.astype(np.int32), sr),
            "lit": lit32.reshape(lr, 128)}
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def literal_runs(recs: dict, device="cuda") -> dict:
    """The scanner's literal runs as tensors on ``device``, for the v9
    decode's scatter: {"pos": output offset, "lit0": first byte's index in
    "lit", "len": run length}, int64, and "lit": the dense literal bytes,
    uint8."""
    dev = resolve_device(device)
    host = {"pos": recs["r_pos"].astype(np.int64),
            "lit0": recs["r_lit0"].astype(np.int64),
            "len": recs["r_j0len"].astype(np.int64) & 0xFF,
            "lit": np.asarray(recs["lit"], np.uint8)}
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
