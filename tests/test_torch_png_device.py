"""decode_png_device of the PyTorch port on device="cpu" (the kernels'
plain versions) against the JAX package's fused PNG path (Pallas kernels in
interpret mode), its host decoder and the source pixels; and the error
classes of both.  Every comparison is on bytes and exact."""

import numpy as np
import pytest

from debigulator_tpu.models import pipeline as jax_pl
from debigulator_tpu.models import png_codec as jax_png
from debigulator_tpu_torch.models import png_codec, zlib_codec
from debigulator_tpu_torch.models import pipeline as pl
from torch_png_cases import CASES, corrupt, make_case
from torch_stream_cases import ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


@pytest.mark.parametrize("color_type,h,w", CASES)
def test_decode_png_device_matches_jax_and_source(color_type, h, w, monkeypatch):
    """RGBA and palette+tRNS go through the JAX package's fused device path
    (each shape is a fresh interpret-mode compile, so not all five do; the
    corpus tests run every color type through the fused corpus path); the
    other color types are held against its host decoder."""
    png, rgba = make_case(color_type, h, w, seed=10 + color_type)
    got = pl.decode_png_device(png, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (h, w, 4)
    assert np.array_equal(got, rgba)
    if color_type in (6, 3):
        monkeypatch.setenv("DBG_FORCE_FUSED_PNG", "1")
        want = np.asarray(jax_pl.decode_png_device(png))
    else:
        want = jax_png.decode_png(png)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["crc", "adler", "size", "interlace",
                                  "depth16"])
def test_errors_match_jax(kind, monkeypatch):
    monkeypatch.setenv("DBG_FORCE_FUSED_PNG", "1")
    png = corrupt(kind)
    with pytest.raises(ValueError) as want:
        jax_pl.decode_png_device(png)
    with pytest.raises(ValueError) as got:
        pl.decode_png_device(png, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__ == "PngError"
    assert str(got.value) == str(want.value)
    with pytest.raises(png_codec.PngError):
        pl.decode_png_corpus_device([png], device="cpu")
    if kind == "crc":
        ok = pl.decode_png_device(png, verify_crc=False, device="cpu")
        assert ok.shape == (12, 10, 4)
    if kind == "adler":
        ok = pl.decode_png_device(png, verify_adler=False, device="cpu")
        assert ok.shape == (12, 10, 4)
        with pytest.raises(zlib_codec.ZlibError):  # the host path's class
            png_codec.decode_png(png)
