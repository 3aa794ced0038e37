"""The port's tensor-op Huffman table and one-code decode
(ops/huffman.build_decode_table_tensor, decode_one_msb_tensor) and its
canonical codes against the host table and the JAX package's
``build_decode_table_jnp`` / ``decode_one_msb_jnp`` (the mirror of
tests/test_huffman.py's jnp tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debigulator_tpu import constants as jax_C
from debigulator_tpu.ops import huffman as jax_huff
from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.ops import huffman as huff
from test_huffman import _random_complete_lengths

KEYS = ("count", "first_code", "index_base", "syms", "oversubscribed")


def _tensor_table(lengths, n):
    return huff.build_decode_table_tensor(torch.from_numpy(lengths), n)


@pytest.mark.parametrize("seed", range(4))
def test_tensor_table_matches_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        n = int(rng.integers(2, 40))
        lengths = _random_complete_lengths(rng, n)
        t_np = huff.build_decode_table(lengths)
        t = _tensor_table(lengths, n)
        t_j = jax_huff.build_decode_table_jnp(jnp.asarray(lengths), n)
        assert set(t) == set(KEYS)
        for k in KEYS:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(t_j[k]))
        np.testing.assert_array_equal(t["count"].numpy(), t_np.count)
        np.testing.assert_array_equal(t["first_code"].numpy(), t_np.first_code)
        np.testing.assert_array_equal(t["index_base"].numpy(), t_np.index_base)
        np.testing.assert_array_equal(t["syms"].numpy()[: len(t_np.syms)],
                                      t_np.syms)
        assert not bool(t["oversubscribed"])


@pytest.mark.parametrize("lengths", [[1, 1, 1], [2, 2, 2, 2, 2], [1, 2, 2, 2]])
def test_tensor_oversubscription_flag(lengths):
    lengths = np.array(lengths, np.int32)
    t = _tensor_table(lengths, len(lengths))
    assert bool(t["oversubscribed"])
    assert bool(jax_huff.build_decode_table_jnp(jnp.asarray(lengths),
                                                len(lengths))["oversubscribed"])


def test_incomplete_code_matches_jax():
    lengths = np.array([0, 3, 0, 2, 3, 0], np.int32)
    t = _tensor_table(lengths, 6)
    t_j = jax_huff.build_decode_table_jnp(jnp.asarray(lengths), 6)
    for k in KEYS:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(t_j[k]))
    assert not bool(t["oversubscribed"])


@pytest.mark.parametrize("which", ["litlen", "dist"])
def test_decode_one_msb_tensor_fixed_table(which):
    lengths = (C.fixed_litlen_lengths() if which == "litlen"
               else C.fixed_dist_lengths())
    n = len(lengths)
    codes = huff.canonical_codes(lengths)
    np.testing.assert_array_equal(codes, jax_huff.canonical_codes(
        jax_C.fixed_litlen_lengths() if which == "litlen"
        else jax_C.fixed_dist_lengths()))
    t = _tensor_table(lengths, n)
    # 15-bit windows whose top bits are each symbol's code, the rest random.
    rng = np.random.default_rng(2)
    tail = rng.integers(0, 1 << 15, n) & ((1 << (15 - lengths)) - 1)
    windows = ((codes << (15 - lengths)) | tail).astype(np.int32)
    sym, ln = huff.decode_one_msb_tensor(torch.from_numpy(windows), t)
    np.testing.assert_array_equal(sym.numpy(), np.arange(n))
    np.testing.assert_array_equal(ln.numpy(), lengths)
    t_j = jax_huff.build_decode_table_jnp(jnp.asarray(lengths), n)
    sym_j, ln_j = jax_huff.decode_one_msb_jnp(jnp.asarray(windows), t_j)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(sym_j))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(ln_j))


def test_decode_one_msb_tensor_unassigned_code():
    """An incomplete code leaves windows that match nothing: length 0 and
    symbol -1, as the JAX function returns."""
    lengths = np.array([1, 0, 2], np.int32)  # codes 0, 10; 11x unassigned
    t = _tensor_table(lengths, 3)
    windows = np.arange(0, 1 << 15, 97, dtype=np.int32)
    sym, ln = huff.decode_one_msb_tensor(torch.from_numpy(windows), t)
    t_j = jax_huff.build_decode_table_jnp(jnp.asarray(lengths), 3)
    sym_j, ln_j = jax_huff.decode_one_msb_jnp(jnp.asarray(windows), t_j)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(sym_j))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(ln_j))
    assert (sym.numpy()[windows >= 3 << 13] == -1).all()


def test_canonical_codes_match_jax_and_reject_oversubscription():
    rng = np.random.default_rng(9)
    for _ in range(10):
        lengths = _random_complete_lengths(rng, int(rng.integers(2, 60)))
        np.testing.assert_array_equal(huff.canonical_codes(lengths),
                                      jax_huff.canonical_codes(lengths))
    with pytest.raises(huff.HuffmanError):
        huff.canonical_codes(np.array([1, 1, 1]))
