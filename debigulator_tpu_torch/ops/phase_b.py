"""Phase B: Phase A tapes -> decoded bytes (the port of
debigulator_tpu/ops/phase_b_v15.py's flagship path).

* ``prep_records`` is the glue twin of ``resolve_segmented_v15``
  (phase_b_v15.py:864-903): per-cell output bases (``cbase`` cumsum),
  per-record dst/meta in cell-major order, and the 128-row-aligned chunk
  row bases.
* ``compact`` (kernel csrc/compact.cu, replacing ``_compact_kernel``)
  turns the padded tapes into dense dst-sorted record lists, padding
  included exactly as the reference lays it out.
* ``size8`` is the reference's frontier-batch rule (phase_b_v15.py:
  931-953), kept as a contract at that kernel boundary; the walk below
  does not need it.
* ``walk`` (kernel csrc/walk.cu, replacing ``_walk_kernel_v16``) places
  the literal runs and resolves the matches over one flat output buffer
  with the 32 KiB window prologue just before the body, as a grid-wide
  source chase that needs no stream boundaries.

``resolve`` chains them; its output is the reference's body: n_seg *
seg_bytes int32 values, one byte each.

``plan_records`` / ``run_records`` feed the same walk from record lists
built on the host (the reference's ``plan_records_v15`` /
``run_records_v15``, the split-stream decode's per-shard resolver), with
a neighbour's tail as the window and a previous output as the body.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.device import plain_here as _plain_here
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops.plan import SEG_BYTES, TC
from debigulator_tpu_torch.utils.profiling import named_scope

WINDOW = C.WINDOW_SIZE
BIG = 1 << 30
GROUP = 8
#: Cells per compact chunk (phase_b_v15.CHUNK_CELLS).
CHUNK_CELLS = TC
#: Slack rows of the dense arrays past the tapes (phase_b_v15.SUB_ROWS + 16).
DENSE_SLACK_ROWS = 256 + 16
#: Run meta keeps the literal-tape row in bits 14..31.
LIT_ROW_LIMIT = 1 << 18


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (the reference's int32
    arithmetic, made explicit)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


@dataclasses.dataclass
class Records:
    """Cell-major record arrays and chunk bases for ``compact``."""

    dm: torch.Tensor  # (cells_pad*slots,) match dst (0 where invalid)
    mm: torch.Tensor  # match meta len << 16 | dist (0 = padding)
    dr: torch.Tensor  # run dst
    mr: torch.Tensor  # run meta litrow << 14 | lane0 << 7 | len
    mbase: torch.Tensor  # (n_chunks,) dense row base of each chunk
    rbase: torch.Tensor
    lit: torch.Tensor  # (cells_pad*slots,) literal tape, cell-major


def prep_records(ma, mb, ra, rb, lit, cnt, outlen, bob_cell,
                 slots: int) -> Records:
    """Glue between Phase A and compact (phase_b_v15.py:864-903)."""
    cells_pad = ma.shape[1]
    if cells_pad % CHUNK_CELLS:
        raise ValueError("cells_pad must be a multiple of the chunk size")
    if cells_pad * slots // 128 > LIT_ROW_LIMIT:
        raise ValueError(
            f"lit tape {cells_pad * slots // 128} rows exceeds the run-meta "
            "field (2^18); split the batch")
    dev = ma.device
    n_chunks = cells_pad // CHUNK_CELLS
    cpr = 128 // slots
    mc = (cnt >> 16) & 0xFF
    rc = (cnt >> 8) & 0xFF
    cl = outlen.long()
    bob = bob_cell.long()
    cbase = (bob + torch.cumsum(cl, 0) - cl)
    slot = torch.arange(slots, device=dev)[:, None]
    vm = slot < mc[None, :]
    vr = slot < rc[None, :]
    dstm = torch.where(vm, _wrap32(ma.long() + cbase[None, :]), 0)
    metam = torch.where(vm, mb, 0)
    dstr = torch.where(vr, _wrap32(ra.long() + cbase[None, :]), 0)
    cell = torch.arange(cells_pad, device=dev)[None, :]
    litrow = cell // cpr
    lane0 = (cell % cpr) * slots + (rb.long() >> 16)
    metar = torch.where(
        vr, _wrap32((litrow << 14) | (lane0 << 7) | (rb.long() & 0xFFFF)), 0)

    def cell_major(t):
        return t.T.contiguous().view(-1)

    mrows = -(-mc.view(n_chunks, CHUNK_CELLS).sum(1) // 128)
    rrows = -(-rc.view(n_chunks, CHUNK_CELLS).sum(1) // 128)
    return Records(
        dm=cell_major(dstm), mm=cell_major(metam),
        dr=cell_major(dstr), mr=cell_major(metar),
        mbase=(torch.cumsum(mrows, 0) - mrows).to(torch.int32),
        rbase=(torch.cumsum(rrows, 0) - rrows).to(torch.int32),
        lit=cell_major(lit))


# ---------------------------------------------------------------------------
# Compact
# ---------------------------------------------------------------------------


def _chunk_layout(d, m, base, per_chunk: int, cap_rows: int):
    """Per-chunk fill value (prefix max of valid dst through the chunk)
    and region end row (the next chunk's base; base + cap_rows for the
    last chunk, the reference's tail fill)."""
    n_chunks = base.shape[0]
    cmax = torch.where(m != 0, d, 0).view(n_chunks, per_chunk).amax(1)
    fill = torch.cummax(cmax.clamp(min=0), 0).values.to(torch.int32)
    end = torch.empty_like(base)
    end[:-1] = base[1:]
    end[-1:] = base[-1:] + cap_rows
    return fill, end


def _compact_shape(rec: Records, slots: int):
    """(per_chunk, cap_rows, dense_rows) of a compact call on ``rec``."""
    per_chunk = CHUNK_CELLS * slots
    cap_rows = per_chunk // 128 + 2
    n_rec = rec.dm.numel()
    if n_rec % per_chunk:
        raise ValueError("record count is not a whole number of chunks")
    return per_chunk, cap_rows, n_rec // 128 + cap_rows + DENSE_SLACK_ROWS


def _compact_list_plain(d, m, base, fill, end, per_chunk: int,
                        dense_rows: int):
    """Plain PyTorch compaction of one list: valid records (meta != 0) to
    base*128 + rank within their chunk; the rest of each chunk's region
    [base, end) gets (fill, 0); everything past is (BIG, 0)."""
    dev = d.device
    n_chunks = base.shape[0]
    valid = (m != 0).view(n_chunks, per_chunk)
    rank = torch.cumsum(valid.long(), 1) - 1
    at = (base.long()[:, None] * 128 + rank)[valid]
    odst = torch.full((dense_rows * 128,), BIG, dtype=torch.int32, device=dev)
    ometa = torch.zeros(dense_rows * 128, dtype=torch.int32, device=dev)
    pos = torch.arange(int(end[-1]) * 128, device=dev)
    owner = torch.searchsorted(base.long() * 128, pos, right=True) - 1
    odst[: pos.numel()] = fill[owner]
    odst[at] = d.view(n_chunks, per_chunk)[valid]
    ometa[at] = m.view(n_chunks, per_chunk)[valid]
    return odst, ometa


def compact_plain(rec: Records, slots: int):
    """Plain PyTorch version of ``compact``, on any device."""
    per_chunk, cap_rows, dense_rows = _compact_shape(rec, slots)
    out = []
    for d, m, base in ((rec.dm, rec.mm, rec.mbase), (rec.dr, rec.mr, rec.rbase)):
        fill, end = _chunk_layout(d, m, base, per_chunk, cap_rows)
        out += _compact_list_plain(d, m, base, fill, end, per_chunk, dense_rows)
    return tuple(out)


def compact(rec: Records, slots: int):
    """Dense dst-sorted match and run lists, each (dense_rows*128,) int32:
    (mdst, mmeta, rdst, rmeta), equal to the reference's compact_v15 on
    the same records.  Plain version for CPU tensors, CUDA kernel for CUDA
    tensors: one launch that writes every output slot once and finds each
    chunk's fill by a look-back over the chunks before it, after one memset
    of its status words (two per chunk) and ticket counter."""
    if _plain_here(rec.dm):
        return compact_plain(rec, slots)
    per_chunk, cap_rows, dense_rows = _compact_shape(rec, slots)
    n_chunks = rec.dm.numel() // per_chunk
    dev = rec.dm.device
    out = torch.empty((4, dense_rows * 128), dtype=torch.int32, device=dev)
    status = torch.zeros(2 * n_chunks + 1, dtype=torch.int64, device=dev)
    _kernels.launch(
        "dbg_compact", rec.dm, rec.mm, rec.dr, rec.mr, rec.mbase, rec.rbase,
        n_chunks, per_chunk, cap_rows, dense_rows,
        out[0], out[1], out[2], out[3], status)
    compact.launches += 1
    return out[0], out[1], out[2], out[3]


compact.launches = 0


def size8(mdst: torch.Tensor, mmeta: torch.Tensor) -> torch.Tensor:
    """Frontier batch sizes: size8[s] = the largest t <= 8 such that every
    record j in [s, s+t) is narrow and has src_j + len_j <= dst_s; 0 marks
    an overlapping (dist < len) or wide record (phase_b_v15.py:931-953)."""
    mlen = mmeta >> 16
    dist = mmeta & 0xFFFF
    req = mdst - dist + mlen
    rp = mdst & 127
    qr = (mdst - dist - rp) & 127
    narrow = (rp + (mlen & 0x1FF) + qr) <= 2 * 128
    n = mdst.numel()
    reqp = torch.cat([req, torch.full((GROUP,), BIG, dtype=req.dtype,
                                      device=req.device)])
    nrwp = torch.cat([narrow, torch.ones(GROUP, dtype=torch.bool,
                                         device=req.device)])
    acc = torch.ones(n, dtype=torch.bool, device=req.device)
    out = torch.zeros(n, dtype=torch.int32, device=req.device)
    for t in range(GROUP):
        acc &= (reqp[t : t + n] <= mdst) & nrwp[t : t + n]
        out += acc.to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# Walk
# ---------------------------------------------------------------------------


def _expand(lens: torch.Tensor):
    """(record index, offset in record) for every byte of the records."""
    rec = torch.repeat_interleave(torch.arange(lens.numel(), device=lens.device),
                                  lens)
    first = torch.cumsum(lens, 0) - lens
    off = torch.arange(rec.numel(), device=lens.device) - first[rec]
    return rec, off


def walk_plain(out, mdst, mmeta, rdst, rmeta, lit):
    """Plain PyTorch walk, in place on ``out`` (flat int32, the window
    prologue in out[:WINDOW]).  Literal runs are a gather from the literal
    tape; matches resolve by pointer jumping: every match byte points at
    its source byte, and ptr = ptr[ptr] until nothing changes, which
    follows each byte's chain of copies back to a literal, stored or
    window byte in O(log chain) passes."""
    n = out.numel()
    live = rmeta != 0
    rm = rmeta[live].long()
    rlen = rm & 0x7F
    rsrc = ((rm & 0xFFFFFFFF) >> 14) * 128 + ((rm >> 7) & 0x7F)
    rec, off = _expand(rlen)
    pos = rdst[live].long()[rec] + WINDOW + off
    out[pos] = lit[rsrc[rec] + off]

    mlen = (mmeta >> 16).long()
    live = (mdst < BIG) & (mlen > 0)
    md = mdst[live].long() + WINDOW
    mdist = (mmeta[live] & 0xFFFF).long()
    rec, off = _expand(mlen[live])
    pos = md[rec] + off
    ptr = torch.arange(n, device=out.device)
    ptr[pos] = (pos - mdist[rec]).clamp(min=0)
    while True:
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    out.copy_(out[ptr])
    return out


def walk(out, mdst, mmeta, rdst, rmeta, lit):
    """Literal runs + matches into ``out`` in place; plain version for CPU
    tensors, the CUDA kernels for CUDA tensors.  ``out`` holds byte values
    (0..255): the kernel marks unresolved match bytes with negative
    pointers in place, so a byte already in ``out`` that no record writes
    is final, and every match byte is resolved from its source.  The
    chase needs neither the reference's batch sizes nor stream boundaries
    (a DEFLATE match reads only its own stream).  With no records at all
    nothing is launched."""
    for t in (out, mdst, mmeta, rdst, rmeta, lit):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("walk inputs must be contiguous int32")
    if _plain_here(out):
        return walk_plain(out, mdst, mmeta, rdst, rmeta, lit)
    if out.numel() >= 1 << 31:
        raise ValueError("walk output must hold fewer than 2^31 elements")
    if not (mdst.numel() or rdst.numel()):
        return out
    _kernels.launch("dbg_walk", out, out.numel(), WINDOW, mdst, mmeta,
                    mdst.numel(), rdst, rmeta, rdst.numel(), lit, lit.numel())
    walk.launches += 1
    return out


walk.launches = 0


def init_body(n_seg: int, stored_pos, stored_val, tail0=None,
              device=None, seg_bytes: int = SEG_BYTES) -> torch.Tensor:
    """Flat output buffer: window prologue (tail0, zeros for a stream
    head) then n_seg*seg_bytes body values with the stored bytes placed."""
    out = torch.zeros(WINDOW + n_seg * seg_bytes, dtype=torch.int32,
                      device=device)
    if tail0 is not None:
        out[:WINDOW] = tail0.reshape(-1)
    if stored_val.numel():
        out[WINDOW + stored_pos.long()] = stored_val.to(torch.int32)
    return out


def resolve(ma, mb, ra, rb, lit, cnt, outlen, bob_cell, n_seg: int,
            stored_pos, stored_val, slots: int, tail0=None) -> torch.Tensor:
    """Phase B: the reference's resolve_segmented_v15 contract.  Returns
    the body (n_seg*SEG_BYTES,) int32, one byte per element.  A merged
    batch of streams resolves as one: no match crosses into another
    stream."""
    with named_scope("v15_prep"):
        rec = prep_records(ma, mb, ra, rb, lit, cnt, outlen, bob_cell, slots)
    with named_scope("v15_compact"):
        mdst, mmeta, rdst, rmeta = compact(rec, slots)
    with named_scope("v15_walk"):
        out = init_body(n_seg, stored_pos, stored_val, tail0,
                        device=ma.device)
        walk(out, mdst, mmeta, rdst, rmeta, rec.lit)
    return out[WINDOW:]


# ---------------------------------------------------------------------------
# Host-built record lists (the split-stream decode's entry)
# ---------------------------------------------------------------------------


def plan_records(m_pos, m_meta, r_pos, r_lit0, r_len, lit, n_seg: int,
                 seg_bytes: int, stored_pos=None, stored_val=None) -> dict:
    """Host plan: dst-sorted record lists -> the walk's inputs (the port of
    ``plan_records_v15``, phase_b_v15.py:1027), as numpy arrays.

    m_pos/m_meta: matches (pos ascending, meta len << 16 | dist); r_pos/
    r_lit0/r_len: literal runs (length <= 127, pos and literal offsets
    ascending); lit: the literal tape the runs index (only its length is
    read: the caller keeps the tape and stages one copy for every plan,
    ``stage_records``).  Runs split at 128-byte literal rows as
    the reference splits them (phase_b_v15.py:1047-1056).  The lists hold
    exactly the records: the walk reads ``mdst.numel()`` of them, so
    there is no padding.  The stored bytes go into the body at
    ``stored_pos`` (body offsets) by ``run_records``."""
    if -(-len(lit) // 128) > LIT_ROW_LIMIT:
        raise ValueError(
            f"lit tape {-(-len(lit) // 128)} rows exceeds the run-meta "
            "field (2^18); split the stream")
    r_pos = np.asarray(r_pos, np.int64)
    r_lit0 = np.asarray(r_lit0, np.int64)
    r_len = np.asarray(r_len, np.int64)
    len_a = np.minimum(r_len, 128 - (r_lit0 & 127))
    len_b = r_len - len_a
    p2 = np.stack([r_pos, r_pos + len_a], 1).reshape(-1)
    l2 = np.stack([r_lit0, r_lit0 + len_a], 1).reshape(-1)
    n2 = np.stack([len_a, len_b], 1).reshape(-1)
    keep = n2 > 0
    p2, l2, n2 = p2[keep], l2[keep], n2[keep]
    rmeta = ((l2 >> 7) << 14) | ((l2 & 127) << 7) | n2
    empty = np.zeros(0, np.int64)
    return {
        "mdst": np.asarray(m_pos, np.int32),
        "mmeta": np.asarray(m_meta, np.int32),
        "rdst": p2.astype(np.int32),
        "rmeta": rmeta.astype(np.uint32).view(np.int32),
        "stored_pos": np.asarray(empty if stored_pos is None else stored_pos,
                                 np.int64).astype(np.int32),
        "stored_val": np.asarray(empty if stored_val is None else stored_val,
                                 np.uint8),
        "n_seg": int(n_seg),
        "seg_bytes": int(seg_bytes),
    }


def stage_records(plan: dict, device, lit: torch.Tensor) -> dict:
    """A plan_records plan on ``device``: every array as a tensor, the
    sizes as they are, and ``lit``, the plan's literal tape already on
    ``device`` (one copy serves every plan of a stream)."""
    return {**{k: (torch.from_numpy(v).to(device)
                   if isinstance(v, np.ndarray) else v)
               for k, v in plan.items()}, "lit": lit}


def records_buffer(plan: dict, tail0=None, body_init=None) -> torch.Tensor:
    """The flat buffer ``run_records`` walks: the window prologue
    (``tail0``, zeros when None), then ``body_init`` (a patch round replays
    its matches over the previous output) or the stored-byte init."""
    out = init_body(plan["n_seg"], plan["stored_pos"], plan["stored_val"],
                    tail0, device=plan["mdst"].device,
                    seg_bytes=plan["seg_bytes"])
    if body_init is not None:
        if body_init.numel() != out.numel() - WINDOW:
            raise ValueError(f"body_init holds {body_init.numel()} values, "
                             f"the plan's body {out.numel() - WINDOW}")
        out[WINDOW:] = body_init.reshape(-1)
    return out


def run_records(plan: dict, tail0=None, body_init=None) -> torch.Tensor:
    """Run the walk on a staged plan_records plan (the port of
    ``run_records_v15``, phase_b_v15.py:1087) over ``records_buffer``.
    Returns the body, (n_seg * seg_bytes,) int32."""
    out = walk(records_buffer(plan, tail0, body_init), plan["mdst"],
               plan["mmeta"], plan["rdst"], plan["rmeta"], plan["lit"])
    return out[WINDOW:]
