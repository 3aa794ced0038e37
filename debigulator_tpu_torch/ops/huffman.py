"""Canonical Huffman codes and decode tables (the port of
debigulator_tpu/ops/huffman.py).

RFC 1951 §3.2.2 construction in the flat canonical form: per-length
(count, first_code, index_base) plus a symbol permutation sorted by
(code length, symbol).  Two forms:

* ``build_decode_table`` / ``canonical_codes``: NumPy, for the host
  oracle, the plan and the encoder;
* ``build_decode_table_tensor`` / ``decode_one_msb_tensor``: tensor ops on
  the tensors' device (the reference's jittable ``*_jnp`` pair).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from debigulator_tpu_torch.constants import MAX_BITS


class HuffmanError(ValueError):
    pass


@dataclasses.dataclass
class DecodeTable:
    """Canonical-Huffman decode table.

    count: (16,) codes of each length (count[0] is 0); first_code: (16,)
    smallest MSB-first code value of each length; index_base: (16,)
    exclusive prefix sum of count (offset into syms); syms: symbols sorted
    by (code length, symbol); max_len/min_len: bounds over assigned
    lengths; complete: the code exactly fills the code space.
    """

    count: np.ndarray
    first_code: np.ndarray
    index_base: np.ndarray
    syms: np.ndarray
    max_len: int
    min_len: int
    complete: bool


def build_decode_table(lengths: np.ndarray) -> DecodeTable:
    """Canonical decode table from per-symbol code lengths.

    Raises HuffmanError on an over-subscribed code.  Incomplete codes are
    permitted (a stream that uses an unassigned code fails at decode time).
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    if lengths.ndim != 1:
        raise HuffmanError("lengths must be 1-D")
    if np.any(lengths < 0) or np.any(lengths > MAX_BITS):
        raise HuffmanError("code length out of range")
    count = np.bincount(lengths, minlength=MAX_BITS + 1).astype(np.int64)
    count[0] = 0

    first_code = np.zeros(MAX_BITS + 1, dtype=np.int64)
    code = 0
    left = 1  # remaining code space, in codes of the current length
    for bits in range(1, MAX_BITS + 1):
        code = (code + count[bits - 1]) << 1
        first_code[bits] = code
        left = (left << 1) - count[bits]
        if left < 0:
            raise HuffmanError(f"over-subscribed code at length {bits}")

    index_base = np.zeros(MAX_BITS + 1, dtype=np.int64)
    index_base[1:] = np.cumsum(count)[:-1]

    nonzero = np.nonzero(lengths)[0]
    order = np.argsort(lengths[nonzero], kind="stable")
    syms = nonzero[order].astype(np.int32)

    assigned = np.nonzero(count)[0]
    return DecodeTable(
        count=count.astype(np.int32),
        first_code=first_code.astype(np.int32),
        index_base=index_base.astype(np.int32),
        syms=syms,
        max_len=int(assigned.max()) if assigned.size else 0,
        min_len=int(assigned.min()) if assigned.size else 0,
        complete=left == 0,
    )


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Per-symbol MSB-first canonical code values (encoder side).

    Returns (len(lengths),) int32; entries with length 0 are 0.  Raises
    HuffmanError on an over-subscribed code.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    t = build_decode_table(lengths)
    codes = np.zeros(len(lengths), dtype=np.int32)
    next_code = t.first_code.astype(np.int64).copy()
    for sym, ln in enumerate(lengths):
        if ln:
            codes[sym] = next_code[ln]
            next_code[ln] += 1
    return codes


# ---------------------------------------------------------------------------
# Tensor form (the reference's jittable build_decode_table_jnp :123 and
# decode_one_msb_jnp :168)
# ---------------------------------------------------------------------------


def build_decode_table_tensor(lengths: torch.Tensor, num_syms: int) -> dict:
    """Canonical decode table from (num_syms,) code lengths (0 = unused),
    in tensor ops on the lengths' device.

    Returns a dict of tensors: count (16,), first_code (16,), index_base
    (16,), syms (num_syms,) the symbol permutation (unused symbols last),
    oversubscribed () bool, true if the code is invalid.
    """
    lengths = lengths.to(torch.int64)
    dev = lengths.device
    count = torch.bincount(lengths, minlength=MAX_BITS + 1)[: MAX_BITS + 1]
    count[0] = 0

    # first_code[l] = sum over k < l of count[k] << (l - k), on the static
    # 16 x 16 (l, k) grid.
    ln = torch.arange(MAX_BITS + 1, device=dev)
    below = ln[:, None] > ln[None, :]
    shift = torch.where(below, ln[:, None] - ln[None, :], 0)
    first_code = torch.where(below, count[None, :] << shift, 0).sum(1)

    # Over-subscription: first_code[l] + count[l] <= 2^l for every used l.
    capacity = torch.ones_like(ln) << ln
    oversub = ((count > 0) & (first_code + count > capacity)).any()
    index_base = torch.cumsum(count, 0) - count

    # Stable order by length, unused symbols (length 0) keyed past 15.
    sym_ids = torch.arange(num_syms, device=dev)
    key = torch.where(lengths > 0, lengths, MAX_BITS + 1) * (num_syms + 1) \
        + sym_ids
    syms = sym_ids[torch.argsort(key)]
    i32 = torch.int32
    return {"count": count.to(i32), "first_code": first_code.to(i32),
            "index_base": index_base.to(i32), "syms": syms.to(i32),
            "oversubscribed": oversub}


def decode_one_msb_tensor(window15: torch.Tensor, table: dict):
    """Decode one code from 15-bit MSB-first windows (any shape; the first
    stream bit in bit 14) with a table of ``build_decode_table_tensor``.

    Returns (sym, length); length 0 (and sym -1) where no code matches
    (a corrupt stream or an unassigned code).
    """
    count, first_code = table["count"], table["first_code"]
    index_base, syms = table["index_base"], table["syms"]
    length = torch.zeros_like(window15)
    offset = torch.zeros_like(window15)
    for ln in range(1, MAX_BITS + 1):
        off = (window15 >> (MAX_BITS - ln)) - first_code[ln]
        ok = (off >= 0) & (off < count[ln]) & (length == 0)
        length = torch.where(ok, ln, length)
        offset = torch.where(ok, index_base[ln] + off, offset)
    sym = torch.where(length > 0, syms[offset.long()], -1)
    return sym, length
