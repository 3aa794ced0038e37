"""Sequence-parallel decode of ONE DEFLATE stream across devices (the port
of debigulator_tpu/parallel/split_stream.py).

The stream's output splits into consecutive shards, one a device of the
mesh's ``sp`` axis.  A DEFLATE match reaches at most 32 KiB back, so a
shard depends on its left neighbour only through that tail, but the
dependency is transitive (a copy of a copy of the window).  The host scan
already walks every token, so the dependency is computed exactly (native
``dbg_taint``): which matches write bytes that derive from their shard's
incoming window, and whether such bytes reach each shard's outgoing tail.
The device schedule is then:

  phase 1   every shard resolves all its records with a zero window
            (tainted bytes are provisional, every other byte is final)
  round r   each shard's 32 KiB tail moves to its right neighbour, then
            every shard replays only its tainted matches over its own
            output, with that tail as the window

The number of rounds is known on the host: shard s is final in round
``final_round[s] = 0 if s == 0 else (final_round[s-1] + 1 if taint
reaches shard s-1's tail else 1)``.  Typical data needs one round; a
stream-long RLE run needs n_shards - 1.

Each shard's resolver is the walk (``ops.phase_b.run_records`` over
``csrc/walk.cu``, row 3).  A patch round is one walk over the tail and
the previous output with only the tainted matches: the walk treats every
value already in the buffer as final and resolves each match byte from
its source, each patch list writes a byte at most once (the matches of a
stream are disjoint), every source lies below its byte, and taint is
transitive, so every untainted byte a tainted match reads is final.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.native.scanner import taint_matches
from debigulator_tpu_torch.ops import phase_b
from debigulator_tpu_torch.ops.plan import SEG_BYTES
from debigulator_tpu_torch.parallel.batch import ring_tail_exchange
from debigulator_tpu_torch.parallel.mesh import Mesh, make_mesh

WINDOW = phase_b.WINDOW


def _split_at(pos, meta_len, bound_of):
    """Split records (pos, len) at per-record boundaries bound_of(pos).

    Returns (orig_idx, pos, len, lit_advance) with the A and B halves of
    each record interleaved and zero-length halves dropped, so stream
    order is kept.  Works for matches (dist is unchanged by a split) and
    literal runs (the literal offset advances by len_a)."""
    pos = pos.astype(np.int64)
    ln = meta_len.astype(np.int64)
    bound = bound_of(pos)
    len_a = np.minimum(ln, bound - pos)
    len_b = ln - len_a
    idx = np.arange(len(pos), dtype=np.int64)
    p2 = np.stack([pos, bound], 1).reshape(-1)
    l2 = np.stack([len_a, len_b], 1).reshape(-1)
    i2 = np.stack([idx, idx], 1).reshape(-1)
    off2 = np.stack([np.zeros_like(len_a), len_a], 1).reshape(-1)
    keep = l2 > 0
    return i2[keep], p2[keep], l2[keep], off2[keep]


@dataclasses.dataclass
class SplitPlan:
    n_shards: int
    shard_bytes: int  # a multiple of seg_bytes
    n_seg: int  # segments a shard
    seg_bytes: int
    out_size: int
    rounds: int
    phase1: list[dict]  # per shard: phase_b.plan_records of all its records
    patch: list[dict]  # per shard: plan_records of its tainted matches
    lit: np.ndarray  # the literal tape every plan reads (int32)


def plan_split_stream(stream: bytes, n_shards: int,
                      seg_bytes: int | None = None) -> SplitPlan:
    """Host plan: record scan, records split per shard, taint analysis,
    per-shard walk lists.  Needs the native library."""
    from debigulator_tpu_torch.parallel.merged import build_merged_plan

    mp_all = build_merged_plan([stream], records=True)
    recs = mp_all.recs
    out_size = mp_all.plan.out_size
    seg = seg_bytes if seg_bytes is not None else SEG_BYTES
    if seg < WINDOW:
        raise ValueError("seg_bytes must be >= the 32 KiB DEFLATE window")
    shard_bytes = -(-out_size // n_shards)
    shard_bytes = -(-shard_bytes // seg) * seg
    n_seg = shard_bytes // seg

    # Matches split at shard boundaries, then taint.
    m_len = (recs["m_meta"].astype(np.int64) >> 16) & 0xFFFF
    m_dist = recs["m_meta"].astype(np.int64) & 0xFFFF

    def bound(p):
        return (p // shard_bytes + 1) * shard_bytes

    mi, mp_, ml, _ = _split_at(recs["m_pos"].astype(np.int64), m_len, bound)
    m_meta_s = ((ml << 16) | m_dist[mi]).astype(np.int32)
    m_taint, tail_taint = taint_matches(mp_.astype(np.int32), m_meta_s,
                                        out_size, shard_bytes, WINDOW,
                                        n_shards=n_shards)

    # Literal runs split at shard boundaries.
    r_len = recs["r_j0len"].astype(np.int64) & 0xFF
    ri, rp_, rl, roff = _split_at(recs["r_pos"].astype(np.int64), r_len, bound)
    r_lit0_s = recs["r_lit0"].astype(np.int64)[ri] + roff

    lit = np.asarray(recs["lit"], np.int32)
    shard_of_m = mp_ // shard_bytes
    shard_of_r = rp_ // shard_bytes
    sp = np.asarray(mp_all.plan.stored_pos, np.int64)
    sv = np.asarray(mp_all.plan.stored_val, np.uint8)
    tainted = m_taint.astype(bool)
    none = np.zeros(0, np.int64)
    phase1, patch = [], []
    for s in range(n_shards):
        base = s * shard_bytes
        km = shard_of_m == s
        kr = shard_of_r == s
        ks = (sp >= base) & (sp < base + shard_bytes)
        phase1.append(phase_b.plan_records(
            mp_[km] - base, m_meta_s[km], rp_[kr] - base, r_lit0_s[kr],
            rl[kr], lit, n_seg, seg, stored_pos=sp[ks] - base,
            stored_val=sv[ks]))
        kp = km & tainted
        patch.append(phase_b.plan_records(
            mp_[kp] - base, m_meta_s[kp], none, none, none, lit, n_seg, seg))

    # Rounds from the tail-taint chain.
    rounds = fr = 0
    for s in range(1, n_shards):
        fr = fr + 1 if tail_taint[s - 1] else 1
        rounds = max(rounds, fr)

    return SplitPlan(n_shards=n_shards, shard_bytes=shard_bytes, n_seg=n_seg,
                     seg_bytes=seg, out_size=out_size, rounds=rounds,
                     phase1=phase1, patch=patch, lit=lit)


def stage_split(plan: SplitPlan, devices) -> list[tuple[dict, dict]]:
    """Each shard's (phase-1, patch) plan on its device, ``devices[s]``;
    the literal tape is copied once to each distinct device."""
    lits = {d: torch.from_numpy(plan.lit).to(d) for d in dict.fromkeys(devices)}
    return [(phase_b.stage_records(p1, d, lits[d]),
             phase_b.stage_records(pp, d, lits[d]))
            for p1, pp, d in zip(plan.phase1, plan.patch, devices, strict=True)]


def phase1(staged) -> list[torch.Tensor]:
    """Every shard with a zero window: its body, (n_seg * seg_bytes,)."""
    return [phase_b.run_records(p1) for p1, _ in staged]


def patch_round(staged, outs, tails) -> list[torch.Tensor]:
    """One round: every shard replays its tainted matches over its output,
    with its left neighbour's tail as the window."""
    return [phase_b.run_records(pp, tail0=t, body_init=o)
            for (_, pp), o, t in zip(staged, outs, tails, strict=True)]


def _bytes(outs, out_size: int) -> bytes:
    body = torch.cat([o.cpu() for o in outs])[:out_size]
    return body.to(torch.uint8).numpy().tobytes()


def decode_split_emulated(stream: bytes, n_shards: int,
                          seg_bytes: int | None = None,
                          device="cuda") -> bytes:
    """The split-stream schedule with every shard on one device:
    ``decode_split_stream`` over a mesh that repeats ``device``."""
    dev = resolve_device(device)
    return decode_split_stream(
        stream, mesh=make_mesh(dp=1, sp=n_shards, devices=[dev] * n_shards),
        seg_bytes=seg_bytes)


def decode_split_stream(stream: bytes, mesh: Mesh | None = None,
                        n_shards: int | None = None,
                        seg_bytes: int | None = None) -> bytes:
    """Decode ONE raw DEFLATE stream sharded over the mesh's ``sp`` axis
    (mesh row 0; the other rows would hold replicas): each shard resolves
    on its own device, and ``plan.rounds`` rounds of ring tail exchange
    and tainted-match replay make the result exact.  Without a mesh, one
    of ``n_shards`` shards over the CUDA devices (every one by default;
    dp * sp must equal their count, as ``make_mesh`` requires)."""
    if mesh is None:
        mesh = make_mesh(dp=1, sp=n_shards or torch.cuda.device_count())
    sp_devices = list(mesh.devices[0])
    plan = plan_split_stream(stream, len(sp_devices), seg_bytes=seg_bytes)
    staged = stage_split(plan, sp_devices)
    outs = phase1(staged)
    for _ in range(plan.rounds):
        outs = patch_round(staged, outs, ring_tail_exchange(outs, WINDOW))
    return _bytes(outs, plan.out_size)
