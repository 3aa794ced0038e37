"""Checksums of the PyTorch port against zlib and the JAX package: the
native host forms, the GF(2) combine, and the tensor forms on the CPU.
All comparisons are on 32-bit words and exact."""

import zlib

import numpy as np
import pytest
import torch

from debigulator_tpu.ops import checksum as jax_ck
from debigulator_tpu_torch.ops import checksum as ck
from torch_stream_cases import ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


LENGTHS = [0, 1, 5551, 5552, 5553, 65521, 128, 1280, 128 * 517]


def _bytes(n, seed=0):
    return np.random.default_rng(seed + n).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n", LENGTHS)
def test_host_checksums_match_zlib(n):
    data = _bytes(n).tobytes()
    assert ck.crc32(data) == zlib.crc32(data)
    assert ck.adler32(data) == zlib.adler32(data)
    # running forms
    half = n // 2
    assert ck.crc32(data[half:], ck.crc32(data[:half])) == zlib.crc32(data)
    assert ck.adler32(data[half:], ck.adler32(data[:half])) == zlib.adler32(data)


@pytest.mark.parametrize("n", LENGTHS)
def test_tensor_checksums_match_zlib_and_jax(n):
    arr = _bytes(n, seed=1)
    data = arr.tobytes()
    # The inflate body is int32, one byte per element; uint8 works too.
    for t in (torch.from_numpy(arr.astype(np.int32)), torch.from_numpy(arr)):
        assert ck.adler32_device(t) == zlib.adler32(data)
        assert ck.crc32_device(t) == zlib.crc32(data)
    if n:
        assert ck.adler32_device(t) == int(jax_ck.adler32_jnp(arr))
        assert ck.crc32_device(t) == int(jax_ck.crc32_jnp(arr))


@pytest.mark.parametrize("n,length", [(128, 0), (128, 1), (6000, 5552),
                                      (6000, 5553), (70_000, 65521),
                                      (70_000, 69_999)])
def test_length_shorter_than_the_buffer(n, length):
    arr = _bytes(n, seed=2)
    t = torch.from_numpy(arr.astype(np.int32))
    data = arr[:length].tobytes()
    assert ck.adler32_device(t, length) == zlib.adler32(data)
    assert ck.crc32_device(t, length) == zlib.crc32(data)
    assert ck.adler32_device(t, length) == int(jax_ck.adler32_jnp(arr, length))
    assert ck.crc32_device(t, length) == int(jax_ck.crc32_jnp(arr, length))
    out = ck.adler32_tensor(t, torch.tensor(length))
    assert out.dtype == torch.int64 and out.dim() == 0
    assert int(out) == zlib.adler32(data)


def test_length_outside_the_buffer_raises():
    t = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside"):
        ck.adler32_tensor(t, 17)
    with pytest.raises(ValueError, match="outside"):
        ck.crc32_tensor(t, -1)


@pytest.mark.parametrize("la,lb", [(0, 10), (10, 0), (1, 1), (300, 77),
                                   (5553, 65521)])
def test_crc32_combine(la, lb):
    a, b = _bytes(la, seed=3).tobytes(), _bytes(lb, seed=4).tobytes()
    got = ck.crc32_combine(zlib.crc32(a), zlib.crc32(b), lb)
    assert got == zlib.crc32(a + b)
    assert got == jax_ck.crc32_combine(zlib.crc32(a), zlib.crc32(b), lb)


def test_tables_and_shift_match_jax():
    assert np.array_equal(ck.CRC_TABLE, jax_ck.CRC_TABLE)
    assert np.array_equal(ck.SHIFT_POW2, jax_ck.SHIFT_POW2)
    states = np.array([0, 1, 0xDEADBEEF, 0xFFFFFFFF], np.uint32)
    for nbytes in (0, 1, 63, 64, 4097):
        assert np.array_equal(ck.crc_shift(states, nbytes),
                              jax_ck.crc_shift(states, nbytes))
