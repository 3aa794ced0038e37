"""Canonical Huffman decode tables, host form (the port's copy of
``DecodeTable``/``build_decode_table``/``HuffmanError`` from
debigulator_tpu/ops/huffman.py; ``canonical_codes``, the encoder side,
lives in ops.deflate_encode).

RFC 1951 §3.2.2 construction in the flat canonical form: per-length
(count, first_code, index_base) plus a symbol permutation sorted by
(code length, symbol).
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
