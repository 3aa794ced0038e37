"""DEFLATE encoder, host side (the port of
debigulator_tpu/ops/deflate_encode.py), in NumPy as the reference has it.

* ``lz77_parse``: 3-gram hashes at every position, the previous
  occurrences of each hash found by one stable argsort (no hash chains),
  match lengths of all candidates at once 8 bytes a step, then a greedy
  parse that skips literal runs in bulk;
* ``deflate_fixed`` (one fixed-Huffman block, stored fallback),
  ``deflate_dynamic`` (one dynamic block with optimal length-limited codes
  by package-merge) and ``deflate``, the smallest of stored, fixed and
  dynamic: the default encoder of ``encode_zlib``, ``encode_png`` and
  ``encode_gzip``;
* per-token (code, nbits) fields, Huffman codes bit-reversed within their
  width (codes go MSB-first into an LSB-first stream, RFC 1951 §3.1.1),
  and bit packing by an exclusive prefix sum of the field widths and a
  scatter-add of byte contributions, with no serial bit cursor.  The
  device encoder (ops.deflate_encode_device) shares these two.
"""

from __future__ import annotations

import numpy as np

from debigulator_tpu_torch import constants as C
# HuffmanError is part of this module's interface: the code builds raise it.
from debigulator_tpu_torch.ops.huffman import HuffmanError, canonical_codes  # noqa: F401

_FIXED_LITLEN_LENGTHS = C.fixed_litlen_lengths()
_FIXED_LITLEN_CODES = canonical_codes(_FIXED_LITLEN_LENGTHS)
_FIXED_DIST_LENGTHS = C.fixed_dist_lengths()
_FIXED_DIST_CODES = canonical_codes(_FIXED_DIST_LENGTHS)


def _reverse_bits(codes: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Bit-reverse each code within its own width (codes are emitted
    MSB-first into an LSB-first stream, RFC 1951 §3.1.1)."""
    codes = codes.astype(np.uint32)
    rev16 = np.zeros_like(codes)
    for b in range(16):
        rev16 = (rev16 << 1) | ((codes >> b) & 1)
    return rev16 >> (16 - nbits.astype(np.uint32))


def _hash3(data: np.ndarray) -> np.ndarray:
    """Hash of each 3-byte gram (positions 0..n-3)."""
    a = data[:-2].astype(np.uint32)
    b = data[1:-1].astype(np.uint32)
    c = data[2:].astype(np.uint32)
    h = (a << 16) ^ (b << 8) ^ c
    h = (h * np.uint32(2654435761)) >> np.uint32(16)
    return h  # 16-bit bucket space


def _prev_occurrences(h: np.ndarray, k: int = 2) -> np.ndarray:
    """For each position, the k previous positions with the same hash.

    Returns (k, n) int64, -1 where absent.  One argsort, no chains.
    """
    n = len(h)
    order = np.argsort(h, kind="stable")  # groups same-hash, ascending pos
    sorted_h = h[order]
    prevs = np.full((k, n), -1, dtype=np.int64)
    for j in range(1, k + 1):
        cand = np.full(n, -1, dtype=np.int64)
        same = np.zeros(n, dtype=bool)
        same[j:] = sorted_h[j:] == sorted_h[:-j]
        cand_idx = np.where(same)[0]
        cand[cand_idx] = order[cand_idx - j]
        prevs[j - 1, order] = cand
    return prevs


def _match_lengths(data: np.ndarray, pos: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Common-prefix length (capped at 258) of data[pos:] vs data[cand:].

    Word-stepped: compares 8 bytes per round, then resolves the mismatch
    byte within the last word. Invalid candidates (cand<0) get length 0.
    """
    n = len(data)
    valid = cand >= 0
    safe_cand = np.where(valid, cand, 0)
    # Pad data so 8-byte reads never run off the end.
    padded = np.concatenate([data, np.zeros(C.MAX_MATCH_LENGTH + 8, np.uint8)])
    words = padded[: len(padded) - (len(padded) % 8)]
    lengths = np.zeros(len(pos), dtype=np.int64)
    done = ~valid
    for step in range(0, C.MAX_MATCH_LENGTH, 8):
        if done.all():
            break
        a_off = pos + step
        b_off = safe_cand + step
        # gather 8 bytes at arbitrary offsets: build via byte gather
        idx = a_off[:, None] + np.arange(8)
        jdx = b_off[:, None] + np.arange(8)
        aw = padded[idx]
        bw = padded[jdx]
        neq = aw != bw
        any_neq = neq.any(axis=1)
        first_neq = np.argmax(neq, axis=1)
        add = np.where(any_neq, first_neq, 8)
        lengths = np.where(done, lengths, lengths + add)
        done = done | any_neq
    lengths = np.minimum(lengths, C.MAX_MATCH_LENGTH)
    # Matches must not run past the end of the input.
    lengths = np.minimum(lengths, n - pos)
    return np.where(valid, lengths, 0)


def lz77_parse(data: np.ndarray, num_candidates: int = 2):
    """Greedy LZ77 parse.  Returns (lit_mask, match_len, match_dist) arrays
    over positions plus the selected token order implied by greedy stepping.

    Vectorized candidate/length computation; the greedy walk itself touches
    only selected token positions (skipping literal runs in bulk).
    """
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    if n < 4:
        return [(int(b), 0, 0) for b in data]
    h = _hash3(data)
    prevs = _prev_occurrences(h, num_candidates)  # (k, n-2)
    pos = np.arange(n - 2, dtype=np.int64)
    best_len = np.zeros(n, dtype=np.int64)
    best_dist = np.zeros(n, dtype=np.int64)
    for k in range(prevs.shape[0]):
        cand = prevs[k]
        dist = pos - cand
        ok = (cand >= 0) & (dist <= C.WINDOW_SIZE)
        cand = np.where(ok, cand, -1)
        lens = _match_lengths(data, pos, cand)
        better = lens > best_len[: n - 2]
        best_len[: n - 2] = np.where(better, lens, best_len[: n - 2])
        best_dist[: n - 2] = np.where(better, dist, best_dist[: n - 2])
    best_len = np.where(best_len >= C.MIN_MATCH_LENGTH, best_len, 0)

    # Greedy walk with bulk literal-run skipping.
    match_positions = np.flatnonzero(best_len > 0)
    tokens: list[tuple[int, int, int]] = []
    i = 0
    while i < n:
        # next match position >= i
        j = np.searchsorted(match_positions, i)
        nxt = match_positions[j] if j < len(match_positions) else n
        if nxt > i:
            for b in data[i:nxt]:
                tokens.append((int(b), 0, 0))
            i = nxt
        if i < n:
            l, d = int(best_len[i]), int(best_dist[i])
            if l >= C.MIN_MATCH_LENGTH:
                tokens.append((-1, l, d))
                i += l
            else:
                tokens.append((int(data[i]), 0, 0))
                i += 1
    return tokens


def _tokens_to_fields(tokens, litlen_codes, litlen_lengths, dist_codes, dist_lengths):
    """Tokens → flat (value, nbits) bit-field arrays, already bit-reversed
    where the field is a Huffman code (extra-bit fields stay LSB-first).

    tokens: list of (lit,len,dist) tuples, or a (lit, len, dist) array
    triple (lit == -1 marks matches) — the array form skips the
    per-token Python conversion."""
    if isinstance(tokens, tuple):
        lit, mlen, mdist = (np.asarray(a, np.int64) for a in tokens)
    else:
        lit = np.array([t[0] for t in tokens], dtype=np.int64)
        mlen = np.array([t[1] for t in tokens], dtype=np.int64)
        mdist = np.array([t[2] for t in tokens], dtype=np.int64)
    is_match = lit < 0

    # length symbol: searchsorted into LENGTH_BASE
    lsym_rel = np.searchsorted(C.LENGTH_BASE, mlen, side="right") - 1
    lsym_rel = np.clip(lsym_rel, 0, 28)
    # code 285 (len 258) shares base-bucket with 284 — fix exact 258:
    lsym_rel = np.where(mlen == 258, 28, lsym_rel)
    lsym = lsym_rel + 257
    lextra_bits = C.LENGTH_EXTRA_BITS[lsym_rel]
    lextra_val = mlen - C.LENGTH_BASE[lsym_rel]

    dsym = np.searchsorted(C.DIST_BASE, mdist, side="right") - 1
    dsym = np.clip(dsym, 0, 29)
    dextra_bits = C.DIST_EXTRA_BITS[dsym]
    dextra_val = mdist - C.DIST_BASE[dsym]

    litlen_sym = np.where(is_match, lsym, lit)
    f0_bits = litlen_lengths[litlen_sym]
    f0_val = _reverse_bits(litlen_codes[litlen_sym], f0_bits)
    f1_bits = np.where(is_match, lextra_bits, 0)
    f1_val = np.where(is_match, lextra_val, 0).astype(np.uint32)
    f2_bits = np.where(is_match, dist_lengths[dsym], 0)
    f2_val = np.where(
        is_match, _reverse_bits(dist_codes[dsym], dist_lengths[dsym]), 0
    ).astype(np.uint32)
    f3_bits = np.where(is_match, dextra_bits, 0)
    f3_val = np.where(is_match, dextra_val, 0).astype(np.uint32)

    vals = np.stack([f0_val, f1_val, f2_val, f3_val], axis=1).reshape(-1)
    bits = np.stack([f0_bits, f1_bits, f2_bits, f3_bits], axis=1).reshape(-1)
    return vals.astype(np.uint64), bits.astype(np.int64)


def pack_bits(vals: np.ndarray, bits: np.ndarray, prefix_bits: int = 0,
              prefix_val: int = 0) -> tuple[bytes, int]:
    """Pack LSB-first bit fields into bytes via scatter-add.

    Returns (packed bytes, total bit count).  Fields must each be ≤ 32 bits.
    """
    vals = np.asarray(vals, dtype=np.uint64)
    bits = np.asarray(bits, dtype=np.int64)
    if prefix_bits:
        vals = np.concatenate([[np.uint64(prefix_val)], vals])
        bits = np.concatenate([[prefix_bits], bits])
    offs = np.concatenate([[0], np.cumsum(bits)])
    total = int(offs[-1])
    nbytes = (total + 7) // 8 + 8
    out = np.zeros(nbytes, dtype=np.uint64)  # accumulate per-byte then fold
    byte_off = (offs[:-1] >> 3).astype(np.int64)
    bit_rem = (offs[:-1] & 7).astype(np.uint64)
    shifted = vals << bit_rem  # ≤ 32+7 bits → fits u64
    # spread into 5 consecutive bytes
    contrib = np.zeros((len(vals), 5), dtype=np.uint64)
    for b in range(5):
        contrib[:, b] = (shifted >> np.uint64(8 * b)) & np.uint64(0xFF)
    tgt = byte_off[:, None] + np.arange(5)[None, :]
    np.add.at(out, tgt.reshape(-1), contrib.reshape(-1))
    # Bits are disjoint so the per-byte sums are < 256 already.
    assert out.max(initial=0) < 256
    packed = out[: (total + 7) // 8].astype(np.uint8).tobytes()
    return packed, total


def deflate_fixed(data, num_candidates: int = 4) -> bytes:
    """Compress to a raw DEFLATE stream.

    Emits a single fixed-Huffman block (BFINAL=1, BTYPE=1) like stb
    (stb_write.h:915-916), with a stored-block fallback when that would
    exceed the stored encoding (stb_write.h:984-999).
    """
    data = np.frombuffer(memoryview(bytes(data)), dtype=np.uint8)
    n = len(data)
    tokens = lz77_parse(data, num_candidates=num_candidates)
    vals, bits = _tokens_to_fields(
        tokens,
        _FIXED_LITLEN_CODES,
        _FIXED_LITLEN_LENGTHS,
        _FIXED_DIST_CODES,
        _FIXED_DIST_LENGTHS,
    )
    # Append end-of-block (symbol 256: 7-bit code 0) and prepend header
    # BFINAL=1 (1 bit), BTYPE=01 (2 bits LSB-first).
    eob_bits = int(_FIXED_LITLEN_LENGTHS[256])
    eob_val = int(
        _reverse_bits(
            np.array([_FIXED_LITLEN_CODES[256]]), np.array([eob_bits])
        )[0]
    )
    vals = np.concatenate([vals, [np.uint64(eob_val)]])
    bits = np.concatenate([bits, [eob_bits]])
    packed, _ = pack_bits(vals, bits, prefix_bits=3, prefix_val=0b011)
    if len(packed) >= n + 5 * ((n + 65534) // 65535):
        return deflate_stored(data)
    return packed


def _package_merge(freqs: np.ndarray, maxlen: int) -> np.ndarray:
    """Optimal length-limited Huffman code lengths (package-merge).

    freqs: (n,) symbol frequencies.  Returns (n,) lengths (0 for unused),
    all ≤ maxlen, Kraft-complete for ≥2 used symbols.
    """
    syms = np.nonzero(freqs)[0]
    n = len(syms)
    lengths = np.zeros(len(freqs), dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    originals = sorted((int(freqs[s]), (int(s),)) for s in syms)
    prev: list = []
    for _ in range(maxlen):
        merged = sorted(originals + prev, key=lambda t: t[0])
        prev = [
            (merged[i][0] + merged[i + 1][0], merged[i][1] + merged[i + 1][1])
            for i in range(0, len(merged) - 1, 2)
        ]
    # The first n-1 packages of the top level contain each symbol as many
    # times as its code length.
    for _, symset in prev[: n - 1]:
        for s in symset:
            lengths[s] += 1
    return lengths


def _rle_code_lengths(lengths: np.ndarray):
    """RFC 1951 §3.2.7 RLE of code lengths → (symbols, extra_vals, extra_bits)."""
    out_sym, out_val, out_bits = [], [], []
    i, n = 0, len(lengths)
    while i < n:
        l = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == l:
            run += 1
        if l == 0:
            while run >= 3:
                take = min(run, 138)
                if take >= 11:
                    out_sym.append(18)
                    out_val.append(take - 11)
                    out_bits.append(7)
                else:
                    out_sym.append(17)
                    out_val.append(take - 3)
                    out_bits.append(3)
                run -= take
                i += take
            for _ in range(run):
                out_sym.append(0); out_val.append(0); out_bits.append(0)
                i += 1
        else:
            out_sym.append(l); out_val.append(0); out_bits.append(0)
            i += 1
            run -= 1
            while run >= 3:
                take = min(run, 6)
                out_sym.append(16); out_val.append(take - 3); out_bits.append(2)
                run -= take
                i += take
            for _ in range(run):
                out_sym.append(l); out_val.append(0); out_bits.append(0)
                i += 1
    return (
        np.array(out_sym, np.int64),
        np.array(out_val, np.int64),
        np.array(out_bits, np.int64),
    )


def deflate_dynamic(data, num_candidates: int = 4) -> bytes:
    """Compress with a single dynamic-Huffman block (BTYPE=2).

    Code lengths are optimal length-limited (package-merge) for the actual
    token distribution — this is the capability step beyond the reference
    encoder (stb emits fixed-Huffman only, stb_write.h:915-916).
    """
    data_np = np.frombuffer(memoryview(bytes(data)), dtype=np.uint8)
    tokens = lz77_parse(data_np, num_candidates=num_candidates)
    tokens_eob = tokens + [(-2, 0, 0)]  # sentinel handled below

    # Symbol frequencies.
    lit_freq = np.zeros(286, np.int64)
    dist_freq = np.zeros(30, np.int64)
    for t in tokens:
        if t[0] >= 0:
            lit_freq[t[0]] += 1
        else:
            li = int(np.searchsorted(C.LENGTH_BASE, t[1], side="right")) - 1
            if t[1] == 258:
                li = 28
            lit_freq[257 + li] += 1
            di = int(np.searchsorted(C.DIST_BASE, t[2], side="right")) - 1
            dist_freq[di] += 1
    lit_freq[256] += 1  # EOB

    ll_lengths = _package_merge(lit_freq, 15)
    d_lengths = _package_merge(dist_freq, 15)
    hlit = max(257, int(np.nonzero(ll_lengths)[0].max(initial=256)) + 1)
    hdist = max(1, int(np.nonzero(d_lengths)[0].max(initial=0)) + 1)

    # Code-length code.
    all_lengths = np.concatenate([ll_lengths[:hlit], d_lengths[:hdist]])
    cl_sym, cl_val, cl_bits = _rle_code_lengths(all_lengths)
    cl_freq = np.bincount(cl_sym, minlength=19)
    cl_lengths = _package_merge(cl_freq, 7)
    cl_codes = canonical_codes(cl_lengths)

    order = C.CODE_LENGTH_ORDER
    hclen = 19
    while hclen > 4 and cl_lengths[order[hclen - 1]] == 0:
        hclen -= 1

    # Header fields.
    hdr_vals = [0b101, hlit - 257, hdist - 1, hclen - 4]  # BFINAL=1,BTYPE=2
    hdr_bits = [3, 5, 5, 4]
    for i in range(hclen):
        hdr_vals.append(int(cl_lengths[order[i]]))
        hdr_bits.append(3)
    # RLE'd code-length symbols.
    cl_code_vals = _reverse_bits(cl_codes[cl_sym], cl_lengths[cl_sym])
    rle_vals = np.stack([cl_code_vals, cl_val.astype(np.uint32)], 1).reshape(-1)
    rle_bits = np.stack([cl_lengths[cl_sym], cl_bits], 1).reshape(-1)

    ll_codes = canonical_codes(ll_lengths)
    d_codes = canonical_codes(d_lengths)
    vals, bits = _tokens_to_fields(
        tokens, ll_codes, ll_lengths, d_codes, d_lengths
    )
    eob_bits = int(ll_lengths[256])
    eob_val = int(_reverse_bits(np.array([ll_codes[256]]), np.array([eob_bits]))[0])

    all_vals = np.concatenate(
        [np.array(hdr_vals, np.uint64), rle_vals.astype(np.uint64),
         vals, [np.uint64(eob_val)]]
    )
    all_bits = np.concatenate(
        [np.array(hdr_bits, np.int64), rle_bits.astype(np.int64),
         bits, [eob_bits]]
    )
    packed, _ = pack_bits(all_vals, all_bits)
    return packed


def deflate(data, num_candidates: int = 4) -> bytes:
    """Best-of-three DEFLATE: min(stored, fixed, dynamic).  An encoder that
    fails raises: the stored stream is a candidate, not a fallback."""
    data = bytes(data)
    candidates = [deflate_stored(data), deflate_fixed(data, num_candidates)]
    if len(data) >= 64:
        candidates.append(deflate_dynamic(data, num_candidates))
    return min(candidates, key=len)


def deflate_stored(data) -> bytes:
    """Stored-only DEFLATE stream (BTYPE=0 blocks, ≤65535 bytes each)."""
    data = bytes(data)
    n = len(data)
    out = bytearray()
    at = 0
    while True:
        chunk = data[at : at + 65535]
        at += len(chunk)
        final = 1 if at >= n else 0
        out.append(final)  # BFINAL + BTYPE=00, rest of byte padding
        ln = len(chunk)
        out += bytes([ln & 0xFF, ln >> 8, (ln ^ 0xFFFF) & 0xFF, (ln ^ 0xFFFF) >> 8])
        out += chunk
        if final:
            break
    return bytes(out)
