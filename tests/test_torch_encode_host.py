"""The port's host DEFLATE encoder (ops/deflate_encode: lz77_parse,
deflate_fixed, deflate_dynamic, deflate, package-merge, the code-length
RLE) and encode_gzip against the JAX package's, byte for byte, on
numpy-seeded text, random and run-heavy inputs; every stream also decodes
under zlib."""

import gzip
import zlib

import numpy as np
import pytest

from debigulator_tpu.models import gzip_codec as jax_gzip
from debigulator_tpu.ops import deflate_encode as jax_enc
from debigulator_tpu_torch.models import gzip_codec
from debigulator_tpu_torch.ops import deflate_encode as enc
from torch_stream_cases import words

SIZES = (0, 1, 3, 4, 63, 64, 65_535, 65_536)


def make_input(kind: str, size: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "text":
        return words(size // 4 + 8, seed=seed,
                     vocab=(b"v 0.125 ", b"vt 0.5 ", b"f 1/1/1 ", b"\n",
                            b"usemtl ", b"o Mesh "))[:size]
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    # Runs of 1-40 equal bytes from a small alphabet: distance-1 chains and
    # many equal symbol frequencies.
    vals = rng.integers(0, 6, size, dtype=np.uint8)
    lens = rng.integers(1, 40, size)
    return np.repeat(vals, lens)[:size].tobytes()


def both(fn_name: str, *args):
    """(port result or exception type, JAX result or exception type)."""
    out = []
    for mod in (enc, jax_enc):
        try:
            out.append(getattr(mod, fn_name)(*args))
        except Exception as e:  # the two must fail alike
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["text", "random", "runs"])
def test_encoders_match_jax(kind, size):
    data = make_input(kind, size)
    arr = np.frombuffer(data, np.uint8)
    got, want = both("lz77_parse", arr)
    assert got == want
    for name in ("deflate_fixed", "deflate_dynamic", "deflate"):
        got, want = both(name, data)
        assert got == want, name
        if isinstance(got, bytes):
            assert zlib.decompress(got, -15) == data, name


def test_deflate_about_200_kb_matches_jax():
    data = make_input("text", 200_000, seed=3)
    got = enc.deflate(data)
    assert got == jax_enc.deflate(data)
    assert zlib.decompress(got, -15) == data
    assert len(got) < len(enc.deflate_fixed(data))  # the dynamic block won


@pytest.mark.parametrize("num_candidates", [1, 2, 4])
def test_candidate_counts_match_jax(num_candidates):
    data = make_input("runs", 5000, seed=num_candidates)
    assert enc.deflate(data, num_candidates) == \
        jax_enc.deflate(data, num_candidates)
    arr = np.frombuffer(data, np.uint8)
    assert enc.lz77_parse(arr, num_candidates) == \
        jax_enc.lz77_parse(arr, num_candidates)


TIE_FREQS = {
    "two_groups": np.array([5] * 10 + [3] * 7 + [0] * 4 + [1] * 9),
    "all_equal_286": np.full(286, 7),
    "all_equal_19": np.full(19, 2),
    "one_symbol": np.array([0, 0, 9, 0]),
    "none": np.zeros(30, np.int64),
    "fibonacci": np.array([1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233,
                           377, 610, 987, 1597, 2584, 4181, 6765]),
}


@pytest.mark.parametrize("maxlen", [7, 15])
@pytest.mark.parametrize("name", sorted(TIE_FREQS))
def test_package_merge_ties_match_jax(name, maxlen):
    freqs = TIE_FREQS[name]
    got = enc._package_merge(freqs, maxlen)
    want = jax_enc._package_merge(freqs, maxlen)
    np.testing.assert_array_equal(got, want)
    assert got.max(initial=0) <= maxlen


def test_package_merge_random_ties_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        n = int(rng.integers(2, 300))
        freqs = rng.integers(0, 4, n) * rng.integers(0, 2, n)
        for maxlen in (7, 15):
            np.testing.assert_array_equal(enc._package_merge(freqs, maxlen),
                                          jax_enc._package_merge(freqs, maxlen))


def test_rle_code_lengths_match_jax():
    rng = np.random.default_rng(6)
    for _ in range(30):
        runs = rng.integers(1, 160, 12)
        vals = rng.integers(0, 16, 12) * rng.integers(0, 2, 12)
        lengths = np.repeat(vals, runs)
        for got, want in zip(enc._rle_code_lengths(lengths),
                             jax_enc._rle_code_lengths(lengths), strict=True):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fname", [None, b"sample.obj"])
def test_encode_gzip_matches_jax(fname):
    data = make_input("text", 30_000, seed=8)
    got = gzip_codec.encode_gzip(data, fname=fname)
    assert got == jax_gzip.encode_gzip(data, fname=fname)
    assert gzip.decompress(got) == data
    assert gzip_codec.decode_gzip(got) == data
    assert (gzip_codec.parse_first_member(got).fname == fname)


def test_deflate_lets_an_encoder_failure_rise(monkeypatch):
    """The reference's deflate swallows any exception of its fixed and
    dynamic encoders and returns the best stream it has (here the fixed
    block): the failure goes unseen.  The port's raises."""
    def broken(data, num_candidates=4):
        raise ValueError("encoder failed")

    data = make_input("text", 500)
    monkeypatch.setattr(jax_enc, "deflate_dynamic", broken)
    assert jax_enc.deflate(data) == jax_enc.deflate_fixed(data)
    monkeypatch.setattr(enc, "deflate_dynamic", broken)
    with pytest.raises(ValueError, match="encoder failed"):
        enc.deflate(data)
