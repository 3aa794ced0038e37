"""DEFLATE encoder, host side: token fields, bit packing and the stored
fallback (the part of debigulator_tpu/ops/deflate_encode.py that the
device encoder calls, plus ``canonical_codes`` from ops/huffman.py).

The LZ77 selection runs on the device (ops.deflate_encode_device); what
stays on the host, in NumPy as the reference has it, is:

* per-token (code, nbits) fields, Huffman codes bit-reversed within their
  width (codes go MSB-first into an LSB-first stream, RFC 1951 §3.1.1);
* bit packing: an exclusive prefix sum of the field widths, then a
  scatter-add of byte contributions, with no serial bit cursor;
* the stored-block stream used when the fixed-Huffman block would be
  larger than the input.
"""

from __future__ import annotations

import numpy as np

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.ops.inflate_ref import HuffmanError


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Per-symbol MSB-first canonical code values (RFC 1951 §3.2.2).

    Returns (len(lengths),) int32; entries with length 0 are 0.  Raises
    HuffmanError on an over-subscribed code.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    if lengths.ndim != 1:
        raise HuffmanError("lengths must be 1-D")
    if np.any(lengths < 0) or np.any(lengths > C.MAX_BITS):
        raise HuffmanError("code length out of range")
    count = np.bincount(lengths, minlength=C.MAX_BITS + 1).astype(np.int64)
    count[0] = 0
    next_code = np.zeros(C.MAX_BITS + 1, dtype=np.int64)
    code = 0
    left = 1
    for bits in range(1, C.MAX_BITS + 1):
        code = (code + count[bits - 1]) << 1
        next_code[bits] = code
        left = (left << 1) - count[bits]
        if left < 0:
            raise HuffmanError(f"over-subscribed code at length {bits}")
    codes = np.zeros(len(lengths), dtype=np.int32)
    for sym, ln in enumerate(lengths):
        if ln:
            codes[sym] = next_code[ln]
            next_code[ln] += 1
    return codes


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
