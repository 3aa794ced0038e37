"""The device encoder of the PyTorch port on the CPU (the greedy walk's
plain version) against the JAX package (its Pallas walk in interpret
mode) and zlib.  Selections and streams are compared exactly."""

import zlib

import numpy as np
import pytest
import torch

from debigulator_tpu.ops import deflate_encode as jax_enc
from debigulator_tpu.ops import deflate_encode_jnp as jax_dev
from debigulator_tpu_torch.ops import deflate_encode as enc
from debigulator_tpu_torch.ops import deflate_encode_device as dev

#: Positions a chunk of the card's greedy-walk kernel covers (what
#: csrc/greedy_walk.cu's dbg_greedy_chunk reports): the shapes below aim at
#: its boundaries, the plain walk does not depend on it.
KERNEL_CHUNK = 16384

CASES = {
    "text": b"the quick brown fox jumps over the lazy dog " * 200,
    "zeros": bytes(6000),
    "cycle4": b"abcd" * 2000,
    "random": bytes(np.random.RandomState(7).randint(0, 256, 4096,
                                                     dtype=np.uint8)),
    "tiny": b"abc",
    "stride": bytes(np.tile(np.arange(33, dtype=np.uint8), 300)),
    # 258-long matches at distance 13 (a mined distance) across the card
    # kernel's chunk boundaries (three chunks and a ragged end), and an
    # input shorter than one chunk.
    "cross_chunk": bytes(np.tile(np.random.RandomState(5).randint(
        0, 256, 13, dtype=np.uint8), 4000))[: 3 * KERNEL_CHUNK + 123],
    "short": b"short tx" * 300,
}


def _period_977():
    rng = np.random.default_rng(1)
    return bytes(rng.integers(0, 256, 977, dtype=np.uint8)) * 60


@pytest.mark.parametrize("name", [k for k in CASES if k != "tiny"])
def test_selection_matches_jax(name):
    arr = np.frombuffer(CASES[name], np.uint8)
    got = dev.lz77_select_device(arr, stride=33, device="cpu")
    want = jax_dev.lz77_select_device(arr, stride=33)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.int64
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_stream_matches_jax_and_decodes_under_zlib(name):
    data = CASES[name]
    out = dev.deflate_fixed_device(data, stride=33, device="cpu")
    assert out == jax_dev.deflate_fixed_device(data, stride=33)
    assert zlib.decompress(out, -15) == data


def test_random_bytes_take_the_stored_fallback():
    data = CASES["random"]
    out = dev.deflate_fixed_device(data, device="cpu")
    assert out == enc.deflate_stored(data) == jax_enc.deflate_stored(data)
    assert out[0] == 1 and len(out) == len(data) + 5


def test_mined_distances_find_the_period():
    data = _period_977()
    arr = np.frombuffer(data, np.uint8)
    assert dev.mine_distances(arr) == jax_dev.mine_distances(arr)
    assert 977 in dev.mine_distances(arr)
    sel, _, _ = dev.lz77_select_device(arr, mine=False, device="cpu")
    assert len(sel) == 0  # the static ladder alone finds nothing
    for g, w in zip(dev.lz77_select_device(arr, device="cpu"),
                    jax_dev.lz77_select_device(arr), strict=True):
        assert np.array_equal(g, w)
    out = dev.deflate_fixed_device(data, device="cpu")
    assert out == jax_dev.deflate_fixed_device(data)
    assert zlib.decompress(out, -15) == data
    assert len(out) < len(data) // 30


def _walk_loop(best_len, best_dist):
    """The walk written as the loop it is."""
    pos, meta, i, n = [], [], 0, len(best_len)
    while i < n:
        if best_len[i] >= 3:
            pos.append(i)
            meta.append((int(best_len[i]) << 16) | int(best_dist[i]))
            i += int(best_len[i])
        else:
            i += 1
    return pos, meta


@pytest.mark.parametrize("case", ["none", "to_the_end", "cap258", "mixed",
                                  "one", "no_merge", "cross_chunk",
                                  "n_lt_chunk"])
def test_greedy_walk_plain_edge_shapes(case):
    """The plain walk against the loop on shapes that stress the card
    kernel's chunks: no_merge (every len 3: parses from different chunk
    starts never meet, so every chunk re-walks), 258-long matches that
    straddle chunk boundaries, and n below one chunk."""
    rng = np.random.default_rng(3)
    chunk = KERNEL_CHUNK
    n = 2000
    if case in ("no_merge", "cross_chunk"):
        n = 3 * chunk + 777  # several chunks and a ragged end
    elif case == "n_lt_chunk":
        n = chunk - 5
    bl = np.zeros(n, np.int32)
    bd = np.ones(n, np.int32)
    if case == "to_the_end":
        bl[n - 10] = 10  # a match that runs to exactly n
        bl[5] = 3
    elif case == "cap258":
        bl[:] = 258
    elif case == "mixed":
        bl = rng.choice([0, 1, 2, 3, 4, 17, 258], n).astype(np.int32)
        bd = rng.integers(1, 32768, n).astype(np.int32)
    elif case == "one":
        n = 1
        bl, bd = np.array([0], np.int32), np.array([0], np.int32)
    elif case == "no_merge":
        bl[:] = 3
        bd = rng.integers(1, 32768, n).astype(np.int32)
    elif case == "cross_chunk":
        # A 258-long match starting 100, 1 and 257 positions before each
        # boundary, literals between.
        for k, back in zip(range(1, 4), (100, 1, 257)):
            bl[k * chunk - back] = 258
        bl[n - 258] = 258  # and one that ends exactly at n
    elif case == "n_lt_chunk":
        bl = rng.choice([0, 3, 5, 258], n).astype(np.int32)
    pos, meta = dev.greedy_walk(torch.from_numpy(bl), torch.from_numpy(bd))
    want_pos, want_meta = _walk_loop(bl, bd)
    assert pos.dtype == torch.int32 and meta.dtype == torch.int32
    assert pos.tolist() == want_pos and meta.tolist() == want_meta
    assert dev.greedy_walk.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("n", [1, 16384, 16385, 3 * 16384 + 5])
def test_greedy_walk_card_branch_is_one_launch(monkeypatch, n):
    """The card's branch of ``greedy_walk``, taken on CPU tensors with the
    launch recorded instead of made and the kernel's chunk size answered
    here: one launch of dbg_greedy_walk with the arguments the C entry
    declares, record buffers of n // 3 + 1, and a zeroed status of one
    int64 word for each chunk of the size the kernel reports, plus the
    ticket."""
    import ctypes

    from debigulator_tpu_torch.ops import _kernels

    made, asked = [], []
    chunk = 4096  # not the kernel's own: the wrapper must size from the answer

    def constant(entry):
        asked.append(entry)
        return chunk

    monkeypatch.setattr(dev, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "constant", constant)
    monkeypatch.setattr(_kernels, "launch",
                        lambda entry, *a: made.append((entry, a)))
    before = dev.greedy_walk.launches
    bl = torch.full((n,), 3, dtype=torch.int32)
    pos, meta = dev.greedy_walk(bl, torch.ones(n, dtype=torch.int32))
    monkeypatch.undo()
    assert dev.greedy_walk.launches == before + 1
    assert [e for e, _ in made] == ["dbg_greedy_walk"]
    args = made[0][1]
    argtypes = _kernels._ENTRIES["dbg_greedy_walk"][1]
    assert len(args) == len(argtypes)
    for a, at in zip(args, argtypes, strict=True):
        assert isinstance(a, torch.Tensor) if at is ctypes.c_void_p \
            else isinstance(a, int)
    _, _, n_arg, pos_out, meta_out, count, status = args
    assert asked == ["dbg_greedy_chunk"]
    assert _kernels._CONSTANTS["dbg_greedy_chunk"] == "greedy_walk"
    assert n_arg == n
    assert pos_out.numel() == meta_out.numel() == n // 3 + 1
    assert count.dtype == torch.int32 and count.tolist() == [0]
    assert status.dtype == torch.int64
    assert status.numel() == -(-n // chunk) + 1 and not status.any()
    assert pos.numel() == meta.numel() == 0  # the count read back


def test_best_matches_are_real_matches():
    arr = np.frombuffer(CASES["text"] + CASES["stride"], np.uint8)
    dists = [1, 2, 3, 4, 8, 33, 44]
    bl, bd = dev.best_matches(torch.from_numpy(arr.copy()), dists)
    bl, bd = bl.numpy(), bd.numpy()
    assert bl.max() == 258 and set(np.unique(bd)) <= {0, *dists}
    for i in np.nonzero(bl)[0][::97]:
        ln, d = int(bl[i]), int(bd[i])
        assert ln >= 3 and np.array_equal(arr[i : i + ln],
                                          arr[i - d : i - d + ln])


def test_parse_reconstructs_and_short_inputs_are_literals():
    data = np.frombuffer(b"aaaabbbbccccaaaabbbb" * 50, np.uint8)
    got = dev.lz77_parse_device(data, stride=20, device="cpu")
    for g, w in zip(got, jax_dev.lz77_parse_device(data, stride=20),
                    strict=True):
        assert np.array_equal(g, w)
    lit, mlen, mdist = got
    out = bytearray()
    for v, ln, d in zip(lit, mlen, mdist):
        if v >= 0:
            out.append(int(v))
        else:
            for _ in range(int(ln)):
                out.append(out[-int(d)])
    assert bytes(out) == data.tobytes()
    lit, mlen, _ = dev.lz77_parse_device(np.frombuffer(b"abcdefg", np.uint8),
                                         device="cpu")
    assert bytes(lit.astype(np.uint8)) == b"abcdefg" and not mlen.any()


def test_host_pieces_match_jax():
    lengths = np.array([3, 3, 3, 3, 3, 2, 4, 4], np.int32)
    from debigulator_tpu.ops.huffman import canonical_codes

    assert np.array_equal(enc.canonical_codes(lengths),
                          canonical_codes(lengths))
    for name in ("_FIXED_LITLEN_CODES", "_FIXED_LITLEN_LENGTHS",
                 "_FIXED_DIST_CODES", "_FIXED_DIST_LENGTHS"):
        assert np.array_equal(getattr(enc, name), getattr(jax_enc, name))
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 14, 500)
    vals = rng.integers(0, 1 << 13, 500) & ((1 << bits) - 1)
    assert enc.pack_bits(vals, bits, 3, 0b011) == \
        jax_enc.pack_bits(vals, bits, 3, 0b011)
    with pytest.raises(enc.HuffmanError):
        enc.canonical_codes(np.array([1, 1, 1], np.int32))
