"""PNG (un)filtering of the PyTorch port on the CPU (the kernel's plain
version) against the JAX package: the Pallas wavefront kernel in interpret
mode, the NumPy oracle and the encoder's filter search.  Every comparison
is on bytes and bit-exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from debigulator_tpu.ops import unfilter as jax_uf
from debigulator_tpu.ops.unfilter_pallas import unfilter_wavefront_pallas
from debigulator_tpu_torch.ops import unfilter as uf

SHAPES = [(16, 16, 4), (8, 24, 3), (33, 17, 1), (12, 5, 2), (3, 50, 2),
          (1, 7, 4), (9, 1, 3)]


def _filtered(h, w, bpp, seed, ftypes=None):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, (h, 1 + w * bpp), dtype=np.uint8)
    raw[:, 0] = rng.randint(0, 5, h) if ftypes is None else ftypes
    return raw.reshape(-1)


@pytest.mark.parametrize("h,w,bpp", SHAPES)
def test_plain_matches_pallas_and_oracle(h, w, bpp):
    flat = _filtered(h, w, bpp, h * 100 + w)
    got = uf.unfilter_plain(torch.from_numpy(flat), h, w, bpp).numpy()
    assert got.dtype == np.uint8 and got.shape == (h, w * bpp)
    pallas = np.asarray(unfilter_wavefront_pallas(flat, h, w, bpp,
                                                  interpret=True))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, jax_uf.unfilter_image(flat, h, w, bpp))
    assert np.array_equal(got, uf.unfilter_image(flat, h, w, bpp))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_every_filter_type_forced(ftype):
    h, w, bpp = 10, 11, 3
    flat = _filtered(h, w, bpp, 40 + ftype, ftypes=ftype)
    got = uf.unfilter(torch.from_numpy(flat), h, w, bpp).numpy()
    assert np.array_equal(got, jax_uf.unfilter_image(flat, h, w, bpp))
    assert np.array_equal(got, np.asarray(
        unfilter_wavefront_pallas(flat, h, w, bpp, interpret=True)))


def test_wrapper_takes_a_batch_of_same_shape_images():
    h, w, bpp = 14, 9, 4
    flats = np.stack([_filtered(h, w, bpp, s) for s in (1, 2, 3)])
    got = uf.unfilter(torch.from_numpy(flats), h, w, bpp).numpy()
    assert got.shape == (3, h, w * bpp)
    for k in range(3):
        assert np.array_equal(got[k],
                              jax_uf.unfilter_image(flats[k], h, w, bpp))
    assert uf.unfilter.launches == 0  # CPU tensors never count as launches


def test_out_of_range_filter_byte_follows_the_pallas_kernel():
    """A filter byte above 4 predicts None in the Pallas kernel; the host
    oracle raises.  The port follows the kernel in its device form and the
    oracle in its host form."""
    h, w, bpp = 6, 8, 2
    flat = _filtered(h, w, bpp, 9, ftypes=[0, 4, 7, 2, 255, 3])
    got = uf.unfilter_plain(torch.from_numpy(flat), h, w, bpp).numpy()
    pallas = np.asarray(unfilter_wavefront_pallas(flat, h, w, bpp,
                                                  interpret=True))
    assert np.array_equal(got, pallas)
    with pytest.raises(uf.FilterError):
        uf.unfilter_image(flat, h, w, bpp)


@pytest.mark.parametrize("kinds,fast,jax_fast", [
    ((0, 2), "unfilter_rowfast", "unfilter_rowfast"),
    ((0, 1), "unfilter_subfast", "unfilter_subfast"),
])
@pytest.mark.parametrize("h,w,bpp", [(16, 16, 4), (9, 1, 3), (33, 17, 1)])
def test_fast_paths(kinds, fast, jax_fast, h, w, bpp):
    from debigulator_tpu.ops import unfilter_device as jax_ud

    rng = np.random.RandomState(h + w)
    flat = _filtered(h, w, bpp, 77, ftypes=rng.choice(kinds, h))
    got = getattr(uf, fast)(torch.from_numpy(flat), h, w, bpp).numpy()
    want = np.asarray(getattr(jax_ud, jax_fast)(flat, h, w, bpp))
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_uf.unfilter_image(flat, h, w, bpp))


@pytest.mark.parametrize("h,w,bpp", SHAPES)
def test_filter_search_matches_jax_and_numpy(h, w, bpp):
    rng = np.random.RandomState(h * 7 + w)
    raw = rng.randint(0, 256, (h, w * bpp), dtype=np.uint8)
    raw[::3] = raw[0]  # repeated rows, so Up and Paeth win somewhere
    raw[:, : (w // 2) * bpp] //= 32  # smooth half, so Sub wins somewhere
    got = uf.filter_image_best_device(torch.from_numpy(raw), h, w, bpp).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(
        got, np.asarray(jax_uf.filter_image_best_device(raw, h, w, bpp)))
    assert np.array_equal(got, jax_uf.filter_image_best(raw, h, w, bpp))
    assert np.array_equal(got, uf.filter_image_best(raw, h, w, bpp))
    # and the search round-trips through the unfilter
    back = uf.unfilter(torch.from_numpy(got), h, w, bpp).numpy()
    assert np.array_equal(back, raw)


def test_filter_row_matches_jax():
    rng = np.random.RandomState(5)
    raw, prev = rng.randint(0, 256, (2, 24), dtype=np.uint8)
    for f in range(5):
        assert np.array_equal(uf.filter_row(raw, prev, 3, f),
                              jax_uf.filter_row(raw, prev, 3, f))
    with pytest.raises(uf.FilterError):
        uf.filter_row(raw, prev, 3, 5)


def test_wrapper_rejects_bad_inputs():
    flat = torch.from_numpy(_filtered(4, 4, 4, 0))
    with pytest.raises(ValueError, match="uint8"):
        uf.unfilter(flat.to(torch.int32), 4, 4, 4)
    with pytest.raises(ValueError, match="expected"):
        uf.unfilter(flat[:-1], 4, 4, 4)
    with pytest.raises(ValueError, match="bad image shape"):
        uf.unfilter(flat, 4, 4, 5)


def test_height_limit_is_the_shared_memory_of_one_cta():
    assert uf.smem_bytes(4096, 4) == 3 * 4096 * 4 + 4096
    assert uf.smem_bytes(4096, 4) <= uf.SMEM_LIMIT_BYTES
    assert uf.smem_bytes(20_000, 4) > uf.SMEM_LIMIT_BYTES
