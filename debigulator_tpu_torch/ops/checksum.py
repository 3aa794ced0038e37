"""CRC-32 and Adler-32: host forms and lane-parallel tensor forms (the
port of debigulator_tpu/ops/checksum.py).

* Host ``crc32``/``adler32`` go through the native library, or through
  their NumPy forms (lane-parallel CRC, weighted-sum Adler) when
  ``DBG_NO_NATIVE`` switches the library off.
* CRC-32 is linear over GF(2): ``raw(A xor B) = raw(A) xor raw(B)`` and
  leading zero bytes are free.  ``crc_shift``/``crc32_combine`` stitch
  CRCs of adjacent pieces with precomputed "append 2^k zero bytes"
  matrices (``SHIFT_POW2``), in numpy.
* ``crc32_tensor``/``adler32_tensor`` compute the checksums of a tensor of
  byte values on its own device and return a 0-d int64 tensor;
  ``crc32_device``/``adler32_device`` read that word back as an int.
  They are XLA programs in the reference, not Pallas kernels, so plain
  PyTorch ops are the port.  torch has little uint32 arithmetic, so every
  word lives in an int64 below 2^32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from debigulator_tpu_torch.constants import ADLER_MOD, CRC32_POLY
from debigulator_tpu_torch import native as _native_lib
from debigulator_tpu_torch.native import scanner as _native


def _make_crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(CRC32_POLY), t >> 1)
    return t


CRC_TABLE = _make_crc_table()

# ---------------------------------------------------------------------------
# GF(2) matrix algebra over the CRC state (32x32 matrices as 32 uint32 columns)
# ---------------------------------------------------------------------------


def gf2_matvec(mat: np.ndarray, vec):
    """mat: (32,) uint32 columns; vec: uint32 scalar/array. Returns mat @ vec."""
    vec = np.asarray(vec, dtype=np.uint32)
    out = np.zeros_like(vec)
    for j in range(32):
        bit = (vec >> np.uint32(j)) & np.uint32(1)
        out ^= bit * mat[j]
    return out


def gf2_matmat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a @ b) with both as column arrays: result column j = a @ b[:, j]."""
    return gf2_matvec(a, b)


def _zero_byte_matrix() -> np.ndarray:
    """Matrix of one step ``s' = (s >> 8) ^ T[s & 0xFF]`` with input byte 0."""
    cols = np.empty(32, dtype=np.uint32)
    for j in range(32):
        s = np.uint32(1 << j)
        cols[j] = (s >> np.uint32(8)) ^ CRC_TABLE[int(s & np.uint32(0xFF))]
    return cols


def _make_shift_pow2() -> np.ndarray:
    mats = np.empty((32, 32), dtype=np.uint32)
    m = _zero_byte_matrix()
    for k in range(32):
        mats[k] = m
        m = gf2_matmat(m, m)
    return mats


#: SHIFT_POW2[k] = matrix appending 2^k zero bytes (k in 0..31).
SHIFT_POW2 = _make_shift_pow2()


def crc_shift(crc, nbytes: int):
    """Apply "append nbytes zero bytes" to a raw CRC state (scalar or array)."""
    crc = np.asarray(crc, dtype=np.uint32)
    k = 0
    while nbytes:
        if nbytes & 1:
            crc = gf2_matvec(SHIFT_POW2[k], crc)
        nbytes >>= 1
        k += 1
    return crc


def crc32_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """CRC32(A||B) from CRC32(A), CRC32(B), len(B) (zlib-compatible algebra).

    With F(s, M) the table recurrence, crc32(X) ^ ~0 = F(~0, X);
    F(~0, A||B) = shift(F(~0, A), |B|) ^ F(0, B) and
    F(0, B) = F(~0, B) ^ shift(~0, |B|).
    """
    ff = np.uint32(0xFFFFFFFF)
    fa = np.uint32(crc_a) ^ ff
    fb = np.uint32(crc_b) ^ ff
    f0b = fb ^ crc_shift(ff, len_b)
    return int(crc_shift(fa, len_b) ^ f0b ^ ff)


# ---------------------------------------------------------------------------
# Host checksums
# ---------------------------------------------------------------------------


def _crc32_numpy(data, crc: int = 0) -> int:
    """Lane-parallel CRC-32: the byte recurrence runs across lanes and the
    lane CRCs tree-combine with the "append zero bytes" matrices."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    n = buf.size
    if n == 0:
        return crc
    state = np.uint32(crc) ^ np.uint32(0xFFFFFFFF)
    # Leading zeros are free in raw-linear space, so lead with zeros to
    # give every lane the same length.
    lanes = max(1, min(4096, n // 64))
    chunk = -(-n // lanes)
    padded = np.zeros(lanes * chunk, dtype=np.uint8)
    padded[lanes * chunk - n:] = buf
    cols = padded.reshape(lanes, chunk)
    s = np.zeros(lanes, dtype=np.uint32)
    for i in range(chunk):
        s = (s >> np.uint32(8)) ^ CRC_TABLE[(s ^ cols[:, i]) & np.uint32(0xFF)]
    m, width = lanes, chunk
    while m > 1:
        if m % 2:
            s = np.concatenate([np.zeros(1, dtype=np.uint32), s])
            m += 1
        s = crc_shift(s[0::2], width) ^ s[1::2]
        m //= 2
        width *= 2
    # That was F(0, M); F(init, M) adds the shifted initial state.
    raw = s[0] ^ crc_shift(state, n)
    return int(raw ^ np.uint32(0xFFFFFFFF))


def _adler32_numpy(data, adler: int = 1) -> int:
    buf = np.frombuffer(memoryview(data), dtype=np.uint8).astype(np.uint64)
    n = buf.size
    s1 = adler & 0xFFFF
    s2 = (adler >> 16) & 0xFFFF
    if n:
        weights = np.arange(n, 0, -1, dtype=np.uint64)
        s2 = (s2 + n * s1 + int((buf * weights).sum())) % ADLER_MOD
        s1 = (s1 + int(buf.sum())) % ADLER_MOD
    return (s2 << 16) | s1


def crc32(data, crc: int = 0) -> int:
    """CRC-32 of a bytes-like object (native slice-by-8; NumPy under
    DBG_NO_NATIVE)."""
    if _native_lib.disabled():
        return _crc32_numpy(data, crc)
    return _native.crc32(data, crc)


def adler32(data, adler: int = 1) -> int:
    """Adler-32 (zlib flavour) of a bytes-like object (native; NumPy under
    DBG_NO_NATIVE)."""
    if _native_lib.disabled():
        return _adler32_numpy(data, adler)
    return _native.adler32(data, adler)


# ---------------------------------------------------------------------------
# Tensor checksums: same algebra, on the tensor's device
# ---------------------------------------------------------------------------

#: Bytes each CRC lane folds one after another.  The reference scans
#: n/1024-long chunks; eager PyTorch pays a handful of launches per step,
#: so the sequential dimension is held at 64 steps whatever the length and
#: the lanes (n/64 of them, rounded up to a power of two with free leading
#: zeros) carry the rest; the tree combine is log2(lanes) matrix products.
_CRC_CHUNK = 64


@functools.lru_cache(maxsize=None)
def _crc_tensors(device: torch.device):
    return (torch.from_numpy(CRC_TABLE.astype(np.int64)).to(device),
            torch.from_numpy(SHIFT_POW2.astype(np.int64)).to(device))


def _matvec(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """GF(2) mat @ vec for a vector of states: xor of the columns selected
    by each state's bits, folded pairwise (torch has no xor reduction)."""
    bits = (vec[:, None] >> torch.arange(32, device=vec.device)) & 1
    t = bits * mat[None, :]
    width = 32
    while width > 1:
        width //= 2
        t = t[:, :width] ^ t[:, width:]
    return t[:, 0]


def _payload(buf: torch.Tensor, length) -> torch.Tensor:
    buf = buf.reshape(-1)
    n = buf.shape[0] if length is None else int(length)
    if not 0 <= n <= buf.shape[0]:
        raise ValueError(f"length {n} outside the buffer (0..{buf.shape[0]})")
    return buf[:n].to(torch.int64)


def crc32_tensor(buf: torch.Tensor, length=None) -> torch.Tensor:
    """CRC-32 of buf[:length] (byte values 0-255, any integer dtype) as a
    0-d int64 tensor on buf's device."""
    data = _payload(buf, length)
    n = data.shape[0]
    dev = data.device
    table, shift_pow2 = _crc_tensors(dev)
    ff = 0xFFFFFFFF
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    lanes = 1 << max(0, (-(-n // _CRC_CHUNK) - 1).bit_length())
    padded = torch.zeros(lanes * _CRC_CHUNK, dtype=torch.int64, device=dev)
    padded[lanes * _CRC_CHUNK - n:] = data
    cols = padded.view(lanes, _CRC_CHUNK)
    s = torch.zeros(lanes, dtype=torch.int64, device=dev)
    for i in range(_CRC_CHUNK):
        s = (s >> 8) ^ table[(s ^ cols[:, i]) & 0xFF]
    # Tree combine: the left lane of a pair is followed by `width` bytes.
    k = _CRC_CHUNK.bit_length() - 1
    while s.shape[0] > 1:
        s = _matvec(shift_pow2[k], s[0::2]) ^ s[1::2]
        k += 1
    # s is F(0, 0^pad || M); the initial state ~0 adds shift(~0, n).
    init = int(crc_shift(np.uint32(ff), n))
    return s[0] ^ init ^ ff


def adler32_tensor(buf: torch.Tensor, length=None) -> torch.Tensor:
    """Adler-32 of buf[:length] as a 0-d int64 tensor on buf's device.

    s1 = 1 + sum b_i and s2 = n + sum (n - i) b_i (mod 65521): two
    reductions, no scan.  Weights are reduced first, so a term is below
    2^24 and an int64 sum holds any length a tensor can have."""
    data = _payload(buf, length)
    n = data.shape[0]
    w = torch.arange(n, 0, -1, dtype=torch.int64, device=data.device) % ADLER_MOD
    s1 = (1 + data.sum()) % ADLER_MOD
    s2 = (n % ADLER_MOD + (w * data).sum()) % ADLER_MOD
    return (s2 << 16) | s1


def crc32_device(buf: torch.Tensor, length=None) -> int:
    """CRC-32 of a device-resident byte buffer; one 8-byte readback."""
    return int(crc32_tensor(buf, length))


def adler32_device(buf: torch.Tensor, length=None) -> int:
    """Adler-32 of a device-resident byte buffer; one 8-byte readback."""
    return int(adler32_tensor(buf, length))
