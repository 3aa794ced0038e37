"""Hand-made piece lists for the group resolvers of the PyTorch port (v9,
v10 and v11: rows 10g, 10h and 10a), the same pieces in each version's
encoding, hand-made match lists that rewrite bytes for the match-list
resolvers (v4, v1, v2: rows 8, 10e and 10f) with a serial walk in numpy,
and a Python model of the group chase's C entries (csrc/group_chase.cuh
under each record source: groups_v9.cu, groups_v11.cu, lz77_match.cu,
walk_v14.cu) for the card-branch tests.

A piece case is a list of groups of at most 8 pieces per segment, each
piece (dst, len, src) in buffer positions of one buffer that holds the
cases' segments one after another (pad row, 32 KiB window, bodies, 4 slack
rows).  Every piece stays inside its 128-byte row (v11's words need it),
and pieces of segment 1 read no further back than its window, so the JAX
kernels, one call a segment with the window carried, see the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from debigulator_tpu_torch.ops.archive import lz77_generations as lg
from debigulator_tpu_torch.parallel import merged as tm

SEG = 4096
B = lg.BODY_START
#: The first segment's stream offset (its lims row's column 2): a segment
#: in the middle of a stream.
OFF0 = 3 * SEG
#: Rows of the literal array, and each segment's literal row base.
LIT_ROWS = 100
LIT_BASE = (5, 48)
#: Slots of neighbouring segments' groups before and after the live ones:
#: live-looking pieces that no lims row covers.
JUNK_BEFORE, JUNK_AFTER = 16, 8


def _rng_pieces(rng, k, n_grp, reach=3000):
    """n_grp groups of random pieces in segment k's body, each reading up
    to ``reach`` bytes back (inside the body or the window)."""
    lo = B + k * SEG
    groups = []
    for _ in range(n_grp):
        grp = []
        for _ in range(int(rng.integers(1, 9))):
            d = lo + int(rng.integers(0, SEG - 128))
            n = int(rng.integers(1, 128 - (d & 127) + 1))
            s = d - int(rng.integers(1, reach))
            grp.append((d, n, s))
        groups.append(grp)
    return groups


def _case_reproducer(rng):
    """One group: piece 0 writes body bytes 1000..1019 from 500, piece 1
    copies 10 bytes from 1005 to 1300."""
    return 1, [[(B + 1000, 20, B + 500), (B + 1300, 10, B + 1005)]], False


def _case_own_group(rng):
    """Odd slots read what the slot before them writes."""
    groups = []
    for _ in range(12):
        grp = []
        for j in range(8):
            if j % 2 == 0:
                d = B + int(rng.integers(600, SEG - 128))
                n = int(rng.integers(1, 128 - (d & 127) + 1))
                grp.append((d, n, d - int(rng.integers(1, 600))))
            else:
                pd, pn, _ = grp[-1]
                s = pd + int(rng.integers(0, pn))
                d = int(rng.integers(s + 1, B + SEG - 127))
                grp.append((d, int(rng.integers(1, 128 - (d & 127) + 1)), s))
        groups.append(grp)
    return 1, groups, False


def _case_overlap(rng):
    """dist < len inside one piece: the piece reads the bytes before its
    group, not its own output."""
    groups = []
    for _ in range(8):
        grp = []
        for _ in range(8):
            d = B + int(rng.integers(0, SEG - 128)) // 128 * 128
            d += int(rng.integers(0, 32))
            n = int(rng.integers(40, 128 - (d & 127) + 1))
            grp.append((d, n, d - int(rng.integers(1, 20))))
        groups.append(grp)
    return 1, groups, False


def _case_above(rng, version):
    """Sources whose bytes a later group writes (the piece reads them as
    they were); v11 also reads above its own destination, v9 and v10 read
    their own bytes (distance 0)."""
    groups = [[(B + 1920, 60, B + 900)], [(B + 896, 100, B + 300)]]
    if version == "v11":
        groups.append([(B + 128, 90, B + 2500), (B + 2500, 40, B + 2600)])
    else:
        groups.append([(B + 2944, 90, B + 2944), (B + 3100, 40, B + 2500)])
    groups.append([(B + 2432, 80, B + 100)])
    return 1, groups + _rng_pieces(rng, 0, 6), False


def _case_between(rng):
    """One byte range written by pieces of two groups, a group between them
    and one after both reading it."""
    groups = [[(B + 3000, 40, B + 100)],
              [(B + 3500, 20, B + 3010), (B + 3520, 30, B + 2990)],
              [(B + 3008, 40, B + 200)],
              [(B + 3600, 20, B + 3005)]]
    return 1, groups + _rng_pieces(rng, 0, 4), False


def _case_two_writers(rng):
    """Two pieces of one group write one byte range (the later slot wins),
    groups after it read it."""
    groups = [[(B + 700, 60, B + 10), (B + 800, 5, B + 30),
               (B + 720, 40, B + 400)],
              [(B + 1200, 50, B + 705)],
              [(B + 730, 20, B + 600), (B + 725, 30, B + 20)],
              [(B + 1408, 60, B + 700)]]
    return 1, groups + _rng_pieces(rng, 0, 4), False


def _case_outside(rng, version):
    """Sources below the buffer, one piece partly; for v11 also past its
    end.  The port reads 0 there.  The JAX kernels in interpret mode take a
    row index outside the buffer as an array index (clamped or counted
    from the end; on the TPU such a load is undefined), so these sources
    stay within two rows of the buffer's ends, and the pad row, the
    window's first rows and the slack rows hold zeros, as in a stream's
    first segment: there both read 0."""
    groups = [[(B + 100, 20, -40), (B + 300, 30, -10), (B + 500, 10, 3)]]
    if version == "v11":
        n_out = B + SEG + 512
        groups.append([(B + 700, 20, n_out + 100), (B + 900, 8, -200)])
    return 1, groups + _rng_pieces(rng, 0, 3), True


def _case_padding(rng):
    """Padding slots (length 0) inside groups and a group of padding only,
    besides the neighbouring segments' groups every case has."""
    groups = _rng_pieces(rng, 0, 4)
    groups[0] = groups[0][:1] + [None, None] + groups[0][1:6]
    groups[2] = groups[2][:7] + [None]
    groups.insert(2, [None] * 8)
    return 1, groups, False


def _case_two_segments(rng):
    """Two segments in one call: segment 1 reads segment 0's body and the
    window, and has clashing pieces of its own."""
    seg0 = _rng_pieces(rng, 0, 10)
    seg1 = _rng_pieces(rng, 1, 10, reach=SEG + 2000)
    seg1 += [[(B + SEG + 512, 40, B + SEG + 100),
              (B + SEG + 600, 30, B + SEG + 510)],
             [(B + SEG + 520, 20, B + 4000)]]
    return 2, (seg0, seg1), False


def _case_many_writers(rng):
    """Sixteen groups of eight pieces over one 128-byte row, some reading
    the row itself, then groups reading it."""
    row = B + 1024
    groups = []
    for g in range(16):
        grp = []
        for j in range(8):
            d = row + int(rng.integers(0, 64))
            n = int(rng.integers(1, 128 - (d - row) + 1))
            s = d - (0 if (g + j) % 3 else int(rng.integers(1, 900)))
            grp.append((d, n, s))
        groups.append(grp)
    groups.append([(B + 2048 + 128 * j, 128, row) for j in range(8)])
    return 1, groups + _rng_pieces(rng, 0, 2), False


def _case_mixed(rng):
    """Random pieces over one segment: clashes of every kind."""
    groups = []
    for _ in range(30):
        grp = []
        for _ in range(8):
            d = B + int(rng.integers(0, SEG - 128))
            n = int(rng.integers(1, 128 - (d & 127) + 1))
            grp.append((d, n, d - int(rng.integers(0, 700))))
        groups.append(grp)
    return 1, groups, False


CASES = {
    "reproducer": _case_reproducer,
    "own_group": _case_own_group,
    "overlap": _case_overlap,
    "above": _case_above,
    "between": _case_between,
    "two_writers": _case_two_writers,
    "outside": _case_outside,
    "padding": _case_padding,
    "two_segments": _case_two_segments,
    "many_writers": _case_many_writers,
    "mixed": _case_mixed,
}


def _words(dst, ln, src):
    """v11 piece words of segment-local positions, as
    host_fed._pack_piece_words packs them, a negative load base included."""
    dst, ln, src = (np.asarray(a, np.int64) for a in (dst, ln, src))
    rp = dst & 127
    q = src - rp
    w0 = ((dst >> 7) << 16) | (rp << 8) | (rp + ln)
    w1 = ((q >> 7) << 16) | ((q & 127) << 8) | (128 - (q & 127))
    return w0.astype(np.int32), w1.astype(np.int32)


def make(name: str, version: str, seed: int = 0, odd: bool = False):
    """(init, lims, arrays) of case ``name`` in ``version``'s encoding:
    init (rows, 128) int32, lims (n_seg, 8) int32, arrays gpos/gmeta (and
    lpos/lmeta/lit for v10 and v11) as CPU tensors.  With ``odd`` the
    buffer holds any int32 (-1 and values above 255), its ends too."""
    rng = np.random.default_rng(seed)
    fn = CASES[name]
    made = fn(rng, version) if name in ("above", "outside") else fn(rng)
    n_seg, groups, zero_ends = made
    per_seg = groups if n_seg == 2 else (groups,)
    n_out = B + n_seg * SEG + 512
    init = rng.integers(0, 256, n_out).astype(np.int32)
    if odd:
        init = rng.integers(-(1 << 20), 1 << 20, n_out).astype(np.int32)
        init[::7] = -1
    elif zero_ends:
        init[: 3 * 128] = 0
        init[B + n_seg * SEG :] = 0
    lims = np.zeros((n_seg, 8), np.int64)
    gp, gm = [], []  # slot lists: v9/v10 (pos, meta) or v11 (w0, w1)

    def add(k, piece):
        if piece is None:
            gp.append(OFF0 + k * SEG if version != "v11" else 0)
            gm.append(0)
            return
        d, n, s = piece
        assert 0 < n and (d & 127) + n <= 128
        if version == "v11":
            w0, w1 = _words(d - k * SEG, n, s - k * SEG)
            gp.append(int(w0))
            gm.append(int(w1))
        else:
            assert 0 <= d - s < 1 << 16 and n <= 128
            gp.append(d - B + OFF0)
            gm.append(n << 16 | (d - s))

    for _ in range(JUNK_BEFORE):
        add(0, (B + 50, 50, B + 43))
    for k, grps in enumerate(per_seg):
        lims[k, 0] = len(gp)
        for grp in grps:
            assert len(grp) <= 8
            for piece in grp + [None] * (8 - len(grp)):
                add(k, piece)
        lims[k, 1] = len(gp)
        lims[k, 2] = OFF0 + k * SEG
    for _ in range(JUNK_AFTER):
        add(n_seg - 1, (B + 60, 50, B + 53))
    arrays = {"gpos": np.array(gp), "gmeta": np.array(gm)}
    if version != "v9":
        lp, lm = [], []
        for k in range(n_seg):
            lims[k, 3] = len(lp)
            rel = 128
            for j in range(10):  # disjoint pieces inside one row each
                d = B + k * SEG + 300 * j + int(rng.integers(0, 40))
                n = int(rng.integers(1, 128 - (d & 127) + 1))
                if version == "v11":
                    w0, w1 = _words(d - k * SEG, n, rel)
                    lp.append(int(w0))
                    lm.append(int(w1))
                else:
                    lp.append(d - B + OFF0)
                    lm.append(n << 20 | rel)
                rel += n + 3
            lp += [0 if version == "v11" else OFF0 + k * SEG] * 6
            lm += [0] * 6
            lims[k, 4] = len(lp)
            lims[k, 5] = LIT_BASE[k]
        arrays.update(lpos=np.array(lp), lmeta=np.array(lm))
        arrays["lit"] = rng.integers(0, 256, (LIT_ROWS, 128))
    out = {k: torch.from_numpy(
        tm._pad_rec_rows(v.astype(np.int32), lg.V9_STAGE_ROWS)
        if k != "lit" else v.astype(np.int32)) for k, v in arrays.items()}
    return init.reshape(-1, 128), lims.astype(np.int32), out


def port_call(version, init, lims, t):
    """The port's resolver of ``version`` on the case's arrays."""
    args = (torch.from_numpy(init.copy()), torch.from_numpy(lims.copy()),
            t["gpos"], t["gmeta"])
    fn = {"v9": lg.resolve_groups_v9, "v10": lg.resolve_groups_v10,
          "v11": lg.resolve_groups_v11}[version]
    return fn(*args) if version == "v9" else fn(*args, t["lpos"], t["lmeta"],
                                                 t["lit"])


# ---------------------------------------------------------------------------
# A model of the C entries, on the CPU tensors the wrappers hand them
# ---------------------------------------------------------------------------

K_DONE = 0xFFFFFFFF
ONE_WRITER = 0x7F7F7F7F


def _segment_of(lims, n_seg, lo, hi, t):
    a, b = 0, n_seg
    while a < b:
        m = (a + b) >> 1
        if lims[m * 8 + lo] <= t:
            a = m + 1
        else:
            b = m
    k = a - 1
    return k if k >= 0 and t < lims[k * 8 + hi] else -1


def _unpack(w0, w1):
    rp = (w0 >> 8) & 127
    return ((w0 >> 16) * 128 + rp, min(w0 & 255, 128) - rp,
            (w1 >> 16) * 128 + ((w1 >> 8) & 127) + rp)


def _rec(fn, lo, piece: int = 128):
    """A record source of the model: fn(t) -> (dst, len, src, period), len
    0 for none; lo(t) the first slot of t's group; piece the bound."""
    fn.lo, fn.piece = lo, piece
    return fn


def _groups_of_8(t):
    return t - t % 8


def v9_rec(lims, n_seg, gpos, gmeta):
    """groups_v9::V9Rec: slot t -> (dst, len, src, period)."""
    L, P, M = (x.reshape(-1).tolist() for x in (lims, gpos, gmeta))

    def rec(t):
        if _segment_of(L, n_seg, 0, 1, t - t % 8) < 0:
            return 0, 0, 0, 0
        n = min(M[t] >> 16, 128)
        if n <= 0:
            return 0, 0, 0, 0
        d = P[t] - L[2] + B
        return d, n, d - (M[t] & 0xFFFF), n

    return _rec(rec, _groups_of_8)


def v11_rec(lims, n_seg, gpos, gmeta):
    """groups_v11::PieceRec: slot t -> (dst, len, src, period)."""
    L, P, M = (x.reshape(-1).tolist() for x in (lims, gpos, gmeta))

    def rec(t):
        k = _segment_of(L, n_seg, 0, 1, t - t % 8)
        if k < 0:
            return 0, 0, 0, 0
        d, n, s = _unpack(P[t], M[t])
        if n <= 0:
            return 0, 0, 0, 0
        off = L[k * 8 + 2] - L[2]
        return d + off, n, s + off, n

    return _rec(rec, _groups_of_8)


MATCH_PIECE = 512


def match_rec(pos, meta):
    """lz77_match::MatchRec: match t under the overlap rule, a group of
    its own; len cut at 512 - (dst & 127), none for dist 0."""
    P, M = (x.reshape(-1).tolist() for x in (pos, meta))

    def rec(t):
        dist = M[t] & 0xFFFF
        if M[t] >> 16 <= 0 or dist == 0:
            return 0, 0, 0, 0
        d = P[t]
        return d, min(M[t] >> 16, MATCH_PIECE - (d & 127)), d - dist, dist

    return _rec(rec, lambda t: t, MATCH_PIECE)


def v14_rec(lims, n_seg, mdst, mmeta, m_lo, base_adj, body_end):
    """walk_v14::V14Rec: dense match m_lo + t, clipped to the body; a
    clean group (bit 31 on its aligned first slot) one group with no wrap,
    every other match its own group under the overlap rule."""
    L, D, M = (x.reshape(-1).tolist() for x in (lims, mdst, mmeta))

    def rec(t):
        q = m_lo + t
        meta = M[q]
        d = D[q] + base_adj
        delta = max(B - d, 0)
        eff = max(((meta >> 16) & 0x1FF) - delta, 0)
        d += delta
        eff = min(eff, max(body_end - d, 0), MATCH_PIECE - (d & 127))
        dist = meta & 0xFFFF
        clean = M[q & ~7] < 0
        if eff <= 0 or (dist == 0 and not clean):
            return 0, 0, 0, 0
        return d, eff, d - dist, eff if clean else dist

    def lo(t):
        q = m_lo + t
        q0 = q & ~7
        if M[q0] >= 0:
            return t
        k = _segment_of(L, n_seg, 0, 1, q)
        first = max(q0, L[k * 8]) if k >= 0 else q0
        return max(first - m_lo, 0)

    return _rec(rec, lo, MATCH_PIECE)


def _signed(x):
    return x - (1 << 32) if x >= 1 << 31 else x


NEAR = 32


def group_chase(rec, out, n_out, n, last, first, state, heads, nxt, seed=0):
    """group_chase::launch on CPU tensors: the memsets, then the mark,
    pointer, chase and store passes as the kernels compute them, the
    events of the two spread passes and the rows' lists in a random order
    (the kernels keep none) and the chase in lockstep rounds, every
    element's hop loaded before any is published.  ``rec`` is a record
    source of the model (``_rec``).  Returns the chase's number of
    rounds."""
    flat = out.view(-1)
    piece = rec.piece
    shift = piece.bit_length() - 1
    recs = [rec(t) for t in range(n)]
    events = [(t, d + i, s + i % per) for t, (d, ln, s, per) in enumerate(recs)
              for i in range(ln)]
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(events))
    L = [-1] * n_out  # memset 0xFF
    F = [ONE_WRITER] * n_out  # memset 0x7F
    H = [-1] * heads.numel()  # memset 0xFF
    N = [0] * n
    for t in rng.permutation(n).tolist():  # atomicExch: any order
        d, ln, _, _ = recs[t]
        if ln > 0 and -piece <= d < n_out:
            N[t], H[(d >> shift) + 1] = H[(d >> shift) + 1], t
    for e in order:
        t, p, _ = events[e]
        if 0 <= p < n_out:
            old = L[p]
            L[p] = max(old, t)
            if old >= 0:
                F[p] = min(F[p], old, t)
    out0 = flat.tolist()

    def value(v):
        return (v & 0xFFFFFFFF) << 32 | K_DONE

    def virtual(u, i):
        return (-(u * piece + i) - 2) & 0xFFFFFFFF

    def entry_of(below, s):
        if s < 0 or s >= n_out:
            return value(0)
        if L[s] < 0:
            return value(out0[s])
        if L[s] < below:
            return s
        f = F[s]
        if f == ONE_WRITER or f >= below:
            return value(out0[s])
        for u in range(below - 1, max(f, below - NEAR) - 1, -1):
            d, ln, src, _ = recs[u]
            if ln > 0 and d <= s < d + ln:
                return virtual(u, s - d)
        best = f  # covers s; the rows' lists hold every live piece
        for r in ((s >> shift), (s >> shift) + 1):
            u = H[r]
            while u >= 0:
                d, ln, src, _ = recs[u]
                if best < u < below and d <= s < d + ln:
                    best = u
                u = N[u]
        return virtual(best, s - recs[best][0])

    S = {}
    for e in order:
        t, p, s = events[e]
        if 0 <= p < n_out and L[p] == t:
            S[p] = entry_of(rec.lo(t), s)

    def load(v):
        if v >= 0:
            return S[v]
        ident = -v - 2
        u, i = ident >> shift, ident & (piece - 1)
        d, ln, src, per = recs[u]
        return entry_of(rec.lo(u), src + i % per)

    active = [p for p in S if S[p] & 0xFFFFFFFF != K_DONE]
    rounds = 0
    while active:
        rounds += 1
        hops = [load(_signed(S[p] & 0xFFFFFFFF)) for p in active]
        for p, h in zip(active, hops):
            S[p] = h
        active = [p for p in active if S[p] & 0xFFFFFFFF != K_DONE]
    for p, e in S.items():
        flat[p] = _signed(e >> 32)
    last.copy_(torch.tensor(L, dtype=torch.int32))
    first.copy_(torch.tensor(F, dtype=torch.int32))
    heads.copy_(torch.tensor(H, dtype=torch.int32))
    nxt.copy_(torch.tensor(N, dtype=torch.int32))
    for p, e in S.items():
        state[p] = _signed(e >> 32) << 32 | (e & 0xFFFFFFFF)
    return rounds


def _lits(version):
    """dbg_groups_v10_lits / dbg_groups_v11_lits on CPU tensors."""
    def lits(out, n_out, lims, n_seg, lpos, lmeta, n_slots, lit, n_lit):
        L, P, M = (x.reshape(-1).tolist() for x in (lims, lpos, lmeta))
        flat, fl = out.view(-1), lit.view(-1)
        for t in range(n_slots):
            k = _segment_of(L, n_seg, 3, 4, t - t % 8 if version == "v10"
                            else t)
            if k < 0:
                continue
            if version == "v10":
                n = M[t] >> 20
                d = P[t] - L[2] + B
                s = L[k * 8 + 5] * 128 + (M[t] & 0xFFFFF) - 128
            else:
                d, n, s = _unpack(P[t], M[t])
                d += L[k * 8 + 2] - L[2]
                s += L[k * 8 + 5] * 128 - 128
            for i in range(n):
                if 0 <= d + i < n_out and 0 <= s + i < n_lit:
                    flat[d + i] = fl[s + i]

    return lits


def _check_scratch(n_out, n_slots, piece, last, first, state, heads, nxt):
    assert last.numel() == first.numel() == state.numel() == n_out
    assert heads.numel() == -(-n_out // piece) + 2
    assert nxt.numel() == n_slots
    assert last.dtype == first.dtype == torch.int32
    assert heads.dtype == nxt.dtype == torch.int32
    assert state.dtype == torch.int64


def _v14_runs(out, body_end, base_adj, rdst, rmeta, r_lo, r_hi, lit, n_lit):
    """dbg_walk_v14_runs on CPU tensors."""
    flat, fl = out.view(-1), lit.view(-1)
    D, M = rdst.reshape(-1).tolist(), rmeta.reshape(-1).tolist()
    for i in range(r_lo, r_hi):
        ln, lf = M[i] & 0x7F, (M[i] & 0xFFFFFFFF) >> 7
        for j in range(ln):
            p = D[i] + base_adj + j
            if B <= p < body_end and lf + j < n_lit:
                flat[p] = fl[lf + j]


def emulate(made: list):
    """A stand-in for _kernels.launch that runs the model of each group
    chase entry (and of the literal entries before them) and records the
    entries and their arguments in ``made``."""
    def chase(make_rec):
        def run(out, n_out, lims, n_seg, gpos, gmeta, n_slots, last, first,
                state, heads, nxt):
            _check_scratch(n_out, n_slots, 128, last, first, state, heads,
                           nxt)
            group_chase(make_rec(lims, n_seg, gpos, gmeta), out, n_out,
                        n_slots, last, first, state, heads, nxt)
        return run

    def match(out, n_out, pos, meta, n, last, first, state, heads, nxt):
        _check_scratch(n_out, n, MATCH_PIECE, last, first, state, heads, nxt)
        group_chase(match_rec(pos, meta), out, n_out, n, last, first, state,
                    heads, nxt)

    def v14(out, n_out, body_end, base_adj, lims, n_seg, mdst, mmeta, m_lo,
            m_hi, last, first, state, heads, nxt):
        _check_scratch(n_out, m_hi - m_lo, MATCH_PIECE, last, first, state,
                       heads, nxt)
        group_chase(v14_rec(lims, n_seg, mdst, mmeta, m_lo, base_adj,
                            body_end),
                    out, n_out, m_hi - m_lo, last, first, state, heads, nxt)

    entries = {"dbg_groups_v10_lits": _lits("v10"),
               "dbg_groups_v11_lits": _lits("v11"),
               "dbg_groups_v9_chase": chase(v9_rec),
               "dbg_groups_v11_chase": chase(v11_rec),
               "dbg_lz77_match": match,
               "dbg_walk_v14_runs": _v14_runs,
               "dbg_walk_v14_chase": v14}

    def launch(entry, *args):
        made.append((entry, args))
        entries[entry](*args)

    return launch


# ---------------------------------------------------------------------------
# Match lists that rewrite bytes (rows 8, 10e, 10f)
# ---------------------------------------------------------------------------

#: Hand-made match lists, each (dst, len, dist) offset from the body
#: start, and the n_matches to resolve (None: every entry).
MATCH_LISTS = {
    # A reader falls between two writers of its source.
    "reader_between_writers": ([(1000, 20, 100), (2000, 20, 1000),
                                (1010, 20, 800), (3000, 20, 1990)], None),
    # A later match overwrites an earlier match's source.
    "write_after_read": ([(1000, 20, 500), (500, 20, 300)], None),
    # One byte written by three matches, then read.
    "three_writers": ([(1000, 30, 200), (1010, 30, 400), (1005, 10, 700),
                       (2000, 40, 1000), (1200, 30, 195)], None),
    # Distance 0 and length 0 entries between live ones.
    "dist0_len0": ([(1000, 20, 0), (1100, 0, 50), (1000, 10, 300),
                    (1300, 5, 0), (1400, 30, 400), (1410, 0, 0)], None),
    # A 258-long overlapping run, rewritten and read by later matches.
    "overlap_258": ([(1000, 258, 3), (1100, 258, 1), (1400, 258, 258),
                     (1127, 40, 7), (2000, 258, 900)], None),
    # 16 matches that clash, resolved up to n_matches = 8.
    "n_matches_8": ([(1000 + 37 * i, 30 + i, 25 + 11 * i)
                     for i in range(16)], 8),
}


def match_list(name: str, origin: int, prologue: int):
    """(buffer, pos, meta, n_matches) of MATCH_LISTS[name] as numpy: a
    buffer of random bytes (numpy seed 0) of ``prologue`` bytes (the pad
    row and the window, or the window alone) and 40 rows, the body
    starting at ``origin``; pos and meta (8, 128) int32, padded with
    length-0 entries at ``origin``."""
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 256, prologue + 40 * 128).astype(np.int32)
    recs, n = MATCH_LISTS[name]
    pos = np.full(8 * 128, origin, np.int32)
    meta = np.zeros(8 * 128, np.int32)
    for i, (d, ln, dist) in enumerate(recs):
        pos[i], meta[i] = origin + d, ln << 16 | dist
    return (buf.reshape(-1, 128), pos.reshape(8, 128), meta.reshape(8, 128),
            len(recs) if n is None else n)


def serial_matches(buf, pos, meta, n):
    """The in-order walk of matches 0..n-1 in numpy, a byte at a time."""
    out = buf.reshape(-1).copy()
    for p, m in zip(pos.reshape(-1)[:n].tolist(), meta.reshape(-1)[:n].tolist()):
        ln, d = m >> 16, m & 0xFFFF
        if d == 0:
            continue
        for i in range(ln):
            out[p + i] = out[p - d + i]
    return out.reshape(buf.shape)
