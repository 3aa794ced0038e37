"""Device DEFLATE encoder core (the port of
debigulator_tpu/ops/deflate_encode_jnp.py).

The hot path has no gathers at arbitrary offsets:

* match lengths are computed per CANDIDATE DISTANCE d as run lengths of
  the elementwise equality ``data[i] == data[i-d]``: the next mismatch is
  a reversed cumulative minimum, three tensor passes per distance
  (``best_matches``);
* the candidate set is a static ladder (1..4, 8, the caller's row stride)
  plus distances mined on the host from sampled 4-grams
  (``mine_distances``);
* the greedy selection over the best (len, dist) arrays is one chain:
  ``greedy_walk`` (kernel csrc/greedy_walk.cu, replacing
  ``_greedy_walk_kernel``: chunks speculate at once, then fix their
  entries in order) for CUDA tensors, ``greedy_walk_plain`` (pointer
  doubling) for CPU tensors.

Selected matches feed the host field and bit packing of
ops.deflate_encode, so streams decode under zlib like the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.device import plain_here as _plain_here
from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops import deflate_encode as enc

#: Static candidate distance ladder (plus the caller's row stride).
BASE_DISTANCES = (1, 2, 3, 4, 8)

#: Sampled-candidate mining: positions sampled / top distances added.
_MINE_SAMPLE = 1 << 15
_MINE_TOP = 4


def mine_distances(data: np.ndarray, k: int = _MINE_TOP) -> list[int]:
    """Input-adaptive candidate distances: hash 4-grams at ~32k sampled
    positions, take each sample's distance to the PREVIOUS occurrence of
    its hash, histogram, return the top-k distances.  O(sample) NumPy on
    the host; it adds the data's own repeat periods to the static ladder."""
    n = len(data)
    if n < 4096:
        return []
    step = max(1, n // _MINE_SAMPLE)
    pos = np.arange(0, n - 4, step, dtype=np.int64)
    d = data.astype(np.uint32)
    h = (d[pos] * 2654435761 ^ d[pos + 1] * 40503
         ^ d[pos + 2] * 668265263 ^ d[pos + 3] * 374761393) & 0xFFFF
    order = np.argsort(h, kind="stable")
    hs, ps = h[order], pos[order]
    same = hs[1:] == hs[:-1]
    gaps = (ps[1:] - ps[:-1])[same]
    gaps = gaps[(gaps >= 1) & (gaps < 32768)]
    if not len(gaps):
        return []
    vals, counts = np.unique(gaps, return_counts=True)
    top = vals[np.argsort(-counts)][: 2 * k]
    # Prefer distinct magnitudes (skip near-duplicates of the ladder).
    out = []
    for v in top:
        v = int(v)
        if all(abs(v - e) > 2 for e in list(BASE_DISTANCES) + out):
            out.append(v)
        if len(out) >= k:
            break
    return out


def best_matches(data: torch.Tensor, dists, cap: int = C.MAX_MATCH_LENGTH):
    """Per position, the longest match over the candidate distances (ties
    to the earlier distance in ``dists``): (best_len, best_dist) int32,
    best_len 0 where no candidate reaches MIN_MATCH_LENGTH.  data: (n,)
    byte values on any device."""
    data = data.to(torch.int32)
    n = data.shape[0]
    dev = data.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    best_len = torch.zeros(n, dtype=torch.int32, device=dev)
    best_dist = torch.zeros(n, dtype=torch.int32, device=dev)
    for d in dists:
        eq = torch.cat([torch.zeros(d, dtype=torch.bool, device=dev),
                        data[d:] == data[:-d]])
        # Next mismatch at or after i: a reversed running minimum.
        z = torch.where(eq, n, idx)
        nz = torch.cummin(z.flip(0), 0).values.flip(0)
        ln = torch.clamp(nz - idx, max=cap)
        better = (ln >= C.MIN_MATCH_LENGTH) & (ln > best_len)
        best_len = torch.where(better, ln, best_len)
        best_dist = torch.where(better, d, best_dist)
    return best_len, best_dist


def greedy_walk_plain(best_len: torch.Tensor, best_dist: torch.Tensor):
    """Plain PyTorch greedy selection, on any device: (pos, meta) int32 of
    the matches taken by the walk ``i += len if len >= 3 else 1`` from 0,
    meta = len << 16 | dist.

    The visited positions are the orbit of 0 under ``next``.  Pointer
    doubling marks it without a loop over positions: with the first 2^k
    orbit elements marked and jump = next^(2^k), marking jump[marked]
    doubles the marked prefix; log2(n) rounds of gathers."""
    n = best_len.shape[0]
    dev = best_len.device
    ln = best_len.long()
    take = ln >= C.MIN_MATCH_LENGTH
    step = torch.where(take, ln, 1)
    # Node n is the sink past the end.
    jump = torch.cat([torch.clamp(torch.arange(n, device=dev) + step, max=n),
                      torch.full((1,), n, device=dev)])
    visited = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    visited[0] = True
    for _ in range(max(1, n.bit_length())):
        reach = jump[visited.nonzero()[:, 0]]
        if bool((reach == n).all()):
            break
        visited[reach] = True
        jump = jump[jump]
    pos = (visited[:n] & take).nonzero()[:, 0]
    meta = (ln[pos] << 16) | best_dist.long()[pos]
    return pos.to(torch.int32), meta.to(torch.int32)


def greedy_walk(best_len: torch.Tensor, best_dist: torch.Tensor):
    """Greedy LZ77 selection over per-position best matches: (pos, meta)
    int32, one record per taken match in order.  The plain version for CPU
    tensors, the CUDA kernel for CUDA tensors: chunks of positions (as
    many as the kernel's dbg_greedy_chunk reports) walk speculatively at
    once, then hand their true exits on in ticket order (one int64 status
    word a chunk and the ticket, zeroed here)."""
    for t in (best_len, best_dist):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 1:
            raise ValueError("greedy_walk inputs must be contiguous 1-D int32")
    if best_len.shape != best_dist.shape or best_len.device != best_dist.device:
        raise ValueError("best_len and best_dist must match")
    if _plain_here(best_len):
        return greedy_walk_plain(best_len, best_dist)
    n = best_len.shape[0]
    chunk = _kernels.constant("dbg_greedy_chunk")
    if n >= (1 << 31) - 2 * chunk:
        raise ValueError("greedy_walk takes fewer than 2^31 - 2 chunks of "
                         "positions")
    dev = best_len.device
    # Matches are at least 3 long and do not overlap.
    cap = n // C.MIN_MATCH_LENGTH + 1
    rec = torch.empty((2, cap), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    status = torch.zeros(-(-n // chunk) + 1, dtype=torch.int64, device=dev)
    _kernels.launch("dbg_greedy_walk", best_len, best_dist, n, rec[0], rec[1],
                    count, status)
    greedy_walk.launches += 1
    k = int(count)  # the one synchronizing readback
    return rec[0, :k], rec[1, :k]


greedy_walk.launches = 0


def lz77_select_device(data: np.ndarray, stride: int | None = None,
                       mine: bool = True, device="cuda"):
    """Device lengths + greedy walk.  Returns (sel, lens, dists) int64
    numpy arrays of the selected matches.  mine=True adds input-adaptive
    candidate distances (mine_distances) to the static ladder."""
    dev = resolve_device(device)
    n = len(data)
    dists = list(BASE_DISTANCES)
    if stride and stride not in dists:
        dists.append(int(stride))
    if mine:
        dists.extend(mine_distances(np.asarray(data, np.uint8)))
    dists = sorted(set(d for d in dists if d < n))
    dev_data = torch.from_numpy(np.asarray(data, np.uint8).copy()).to(dev)
    best_len, best_dist = best_matches(dev_data, dists)
    pos, meta = greedy_walk(best_len, best_dist)
    pos = pos.cpu().numpy().astype(np.int64)
    meta = meta.cpu().numpy()
    return pos, (meta >> 16).astype(np.int64), (meta & 0xFFFF).astype(np.int64)


def lz77_parse_device(data: np.ndarray, stride: int | None = None,
                      device="cuda"):
    """Greedy parse using device-computed lengths.

    Returns an ARRAY token triple (lit, len, dist) — lit == -1 marks
    matches — accepted directly by deflate_encode._tokens_to_fields.
    Literal gaps are materialized with vectorized range expansion, never
    per byte.
    """
    data = np.asarray(data, np.uint8)
    n = len(data)
    if n < 8:
        resolve_device(device)
        z = np.zeros(n, np.int64)
        return (data.astype(np.int64), z, z)
    sel, lens, dists = lz77_select_device(data, stride=stride, device=device)
    m = len(sel)
    # Literal gaps: [gap g start, gap g end) = [prev match end, match g).
    gap_start = np.concatenate([[0], sel + lens]) if m else np.array([0])
    gap_end = np.concatenate([sel, [n]]) if m else np.array([n])
    gap_len = gap_end - gap_start
    total_lits = int(gap_len.sum())
    # Vectorized range expansion: source index of each literal byte.
    lit_base = np.cumsum(gap_len) - gap_len
    lit_src = (np.arange(total_lits, dtype=np.int64)
               + np.repeat(gap_start - lit_base, gap_len))
    # Token layout: gap g's literals then match g (last gap has none).
    total = total_lits + m
    lit = np.empty(total, np.int64)
    mlen = np.zeros(total, np.int64)
    mdist = np.zeros(total, np.int64)
    mpos = lit_base[:m] + gap_len[:m] + np.arange(m, dtype=np.int64)
    is_lit = np.ones(total, bool)
    is_lit[mpos] = False
    lit[is_lit] = data[lit_src]
    lit[mpos] = -1
    mlen[mpos] = lens
    mdist[mpos] = dists
    return (lit, mlen, mdist)


def deflate_fixed_device(data, stride: int | None = None,
                         device="cuda") -> bytes:
    """Fixed-Huffman DEFLATE with the device LZ77 core (one block, stored
    fallback when that would be larger than the input)."""
    data_np = np.frombuffer(memoryview(bytes(data)), dtype=np.uint8)
    n = len(data_np)
    tokens = lz77_parse_device(data_np, stride=stride, device=device)
    vals, bits = enc._tokens_to_fields(
        tokens,
        enc._FIXED_LITLEN_CODES, enc._FIXED_LITLEN_LENGTHS,
        enc._FIXED_DIST_CODES, enc._FIXED_DIST_LENGTHS,
    )
    eob_bits = int(enc._FIXED_LITLEN_LENGTHS[256])
    eob_val = int(enc._reverse_bits(
        np.array([enc._FIXED_LITLEN_CODES[256]]), np.array([eob_bits]))[0])
    vals = np.concatenate([vals, [np.uint64(eob_val)]])
    bits = np.concatenate([bits, [eob_bits]])
    packed, _ = enc.pack_bits(vals, bits, prefix_bits=3, prefix_val=0b011)
    if len(packed) >= n + 5 * ((n + 65534) // 65535):
        return enc.deflate_stored(data_np)
    return packed
