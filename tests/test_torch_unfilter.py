"""PNG (un)filtering of the PyTorch port on the CPU (the kernel's plain
version) against the JAX package: the Pallas wavefront kernel in interpret
mode, the NumPy oracle and the encoder's filter search.  Every comparison
is on bytes and bit-exact (tolerance 0)."""

import struct
import zlib

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
        uf.unfilter(flat, 4, 4, 9)


@pytest.mark.parametrize("h,w,bpp,batch", [(20_000, 1, 4, None),
                                            (9_400, 2, 8, None),
                                            (70, 9, 4, 3)])
def test_card_branch_launches_once_at_any_height(monkeypatch, h, w, bpp,
                                                 batch):
    """The wrapper's card branch, taken here on CPU tensors with the launch
    recorded instead of made: one launch with the arguments the C entry
    declares (a tall image, 16-bit RGBA, a batch), a zeroed flag tensor of
    one ticket counter and one count per band, and no height limit."""
    import ctypes

    from debigulator_tpu_torch.ops import _kernels

    made = []
    monkeypatch.setattr(uf, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch",
                        lambda entry, *a: made.append((entry, a)))
    shape = (h * (1 + w * bpp),) if batch is None else (batch, h * (1 + w * bpp))
    before = uf.unfilter.launches
    got = uf.unfilter(torch.zeros(shape, dtype=torch.uint8), h, w, bpp)
    nb = 1 if batch is None else batch
    assert got.shape == ((h, w * bpp) if batch is None else (nb, h, w * bpp))
    assert uf.unfilter.launches == before + 1
    assert [e for e, _ in made] == ["dbg_unfilter"]
    args = made[0][1]
    argtypes = _kernels._ENTRIES["dbg_unfilter"][1]
    assert len(args) == len(argtypes)
    for a, at in zip(args, argtypes, strict=True):
        assert isinstance(a, torch.Tensor) if at is ctypes.c_void_p \
            else isinstance(a, int)
    fil, out, n, hh, ww, bb, sync = args
    assert (n, hh, ww, bb) == (nb, h, w, bpp)
    assert fil.dtype == torch.uint8 and fil.shape == (nb, h, 1 + w * bpp)
    assert out.dtype == torch.uint8 and out.shape == (nb, h, w * bpp)
    bands = -(-h // uf.BAND_ROWS)
    assert sync.dtype == torch.int32 and sync.numel() == 1 + nb * bands
    assert not sync.any()


def _png_rgba8(pix: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit RGBA PNG of (h, w, 4) pixels, filter 0 on every row."""
    from torch_png_cases import _chunk
    from debigulator_tpu_torch import constants as C

    h, w, _ = pix.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          pix.reshape(h, w * 4)], axis=1).tobytes()
    return (C.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))


def test_tall_png_decodes_like_the_reference():
    """A PNG taller than one CTA's shared memory could hold (20,000 x 1
    RGBA8, random pixels from numpy seed 0, filter 0, zlib 6): the port's
    decode_png_device on the CPU equals the reference's decode_png_device
    on the CPU and the source pixels."""
    from debigulator_tpu.models import pipeline as ref_pl
    from debigulator_tpu_torch.models import pipeline as pl

    pix = np.random.default_rng(0).integers(0, 256, (20_000, 1, 4),
                                            dtype=np.uint8)
    png = _png_rgba8(pix)
    got = pl.decode_png_device(png, device="cpu")
    assert got.shape == (20_000, 1, 4) and np.array_equal(got, pix)
    assert np.array_equal(got, np.asarray(ref_pl.decode_png_device(png)))


@pytest.mark.parametrize("h,w,bpp", [(9, 5, 8), (7, 4, 6), (40, 3, 8)])
def test_wide_pixels_match_pallas_and_oracle(h, w, bpp):
    """bpp 5-8 (16-bit RGB and RGBA scanlines): the plain version against
    the Pallas kernel and the oracle."""
    flat = _filtered(h, w, bpp, 7 * h + w)
    got = uf.unfilter(torch.from_numpy(flat), h, w, bpp).numpy()
    assert np.array_equal(got, np.asarray(
        unfilter_wavefront_pallas(flat, h, w, bpp, interpret=True)))
    assert np.array_equal(got, uf.unfilter_image(flat, h, w, bpp))
