"""PNG, zlib and BMP codecs of the PyTorch port (host parse, host decode,
encode on device="cpu") against the JAX package and the source pixels.
PNG inputs are made with zlib and numpy (tests/torch_png_cases.py).  Every
comparison is on bytes and exact."""

import zlib

import numpy as np
import pytest

from debigulator_tpu.models import bmp_codec as jax_bmp
from debigulator_tpu.models import png_codec as jax_png
from debigulator_tpu.ops import deflate_encode_jnp as jax_dev
from debigulator_tpu.ops import unfilter as jax_uf
from debigulator_tpu_torch.models import bmp_codec, png_codec, zlib_codec
from debigulator_tpu_torch.models import pipeline as pl
from torch_png_cases import CASES, make_case
from torch_stream_cases import ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


@pytest.mark.parametrize("color_type,h,w", CASES)
def test_parse_and_host_decode_match_jax(color_type, h, w):
    png, rgba = make_case(color_type, h, w, seed=color_type)
    got, want = png_codec.parse_chunks(png), jax_png.parse_chunks(png)
    assert vars(got.info) == vars(want.info)
    assert (got.info.bpp, got.info.stride) == (want.info.bpp, want.info.stride)
    assert got.idat == want.idat
    for a, b in ((got.palette, want.palette), (got.trns, want.trns)):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert png_codec.get_png_width_height(png) == (w, h)
    out = png_codec.decode_png(png)
    assert np.array_equal(out, rgba)
    assert np.array_equal(out, jax_png.decode_png(png))


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_encode_png_matches_jax_and_round_trips(ch):
    rng = np.random.RandomState(ch)
    h, w = 19, 23
    img = (rng.randint(0, 256, (h, w, ch)) // 16 * 16).astype(np.uint8)
    img[::3] = img[0]
    got = png_codec.encode_png(img, device="cpu")
    want = jax_png.encode_png(
        img,
        deflate_fn=lambda d: jax_dev.deflate_fixed_device(d, stride=1 + w * ch),
        filter_fn=lambda r, hh, ww, cc: np.asarray(
            jax_uf.filter_image_best_device(r, hh, ww, cc)))
    assert got == want
    back = pl.decode_png_device(got, device="cpu")
    assert np.array_equal(back, jax_png.decode_png(got))
    if ch == 4:
        assert np.array_equal(back, img)
    elif ch == 3:
        assert np.array_equal(back[..., :3], img) and (back[..., 3] == 255).all()


def test_zlib_codec_matches_jax():
    from debigulator_tpu.models import zlib_codec as jax_zlib

    data = b"zlib container " * 300
    blob = zlib.compress(data, 7)
    assert zlib_codec.decode_zlib(blob) == data
    assert vars(zlib_codec.parse_zlib_header(blob)) == \
        vars(jax_zlib.parse_zlib_header(blob))
    enc = zlib_codec.encode_zlib(data, device="cpu")
    assert enc == jax_zlib.encode_zlib(data,
                                       deflate_fn=jax_dev.deflate_fixed_device)
    assert zlib.decompress(enc) == data
    bad = bytearray(blob)
    bad[-1] ^= 1
    with pytest.raises(zlib_codec.ZlibError, match="Adler"):
        zlib_codec.decode_zlib(bytes(bad))
    with pytest.raises(zlib_codec.ZlibError, match="FCHECK"):
        zlib_codec.parse_zlib_header(b"\x78\x00")


def test_pil_pngs_decode():
    Image = pytest.importorskip("PIL.Image")
    import io

    rng = np.random.RandomState(11)
    for mode, ch in (("RGBA", 4), ("RGB", 3), ("L", 1), ("LA", 2), ("P", 1)):
        arr = (rng.randint(0, 256, (24, 31, ch)) // 32 * 32).astype(np.uint8)
        img = Image.fromarray(arr[..., 0] if ch == 1 else arr,
                              "L" if mode == "P" else mode)
        if mode == "P":
            img = img.convert("P", palette=Image.ADAPTIVE, colors=8)
        buf = io.BytesIO()
        img.save(buf, "PNG", optimize=True, bits=8)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGBA"))
        got = pl.decode_png_device(buf.getvalue(), device="cpu")
        assert np.array_equal(got, want), mode


def test_bmp_round_trip_matches_jax():
    import torch

    rgba = np.random.RandomState(2).randint(0, 256, (7, 5, 4)).astype(np.uint8)
    blob = bmp_codec.encode_bmp(rgba)
    assert blob == jax_bmp.encode_bmp(rgba)
    assert np.array_equal(bmp_codec.decode_bmp(blob), rgba)
    assert bmp_codec.get_bmp_width_height(blob) == (5, 7)
    for top_down in (True, False):
        px = np.frombuffer(blob, np.uint8, offset=54)
        got = bmp_codec.decode_bmp_tensor(torch.from_numpy(px.copy()), 7, 5,
                                          top_down).numpy()
        want = np.asarray(jax_bmp.decode_bmp_jnp(px, 7, 5, top_down))
        assert np.array_equal(got, want)
    with pytest.raises(bmp_codec.BmpError):
        bmp_codec.decode_bmp(b"XX" + blob[2:])
