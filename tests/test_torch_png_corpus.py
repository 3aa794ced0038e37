"""The corpus, batch and mixed-file entry points of the PyTorch port on
device="cpu" against the JAX package's fused corpus path (Pallas kernels in
interpret mode) and the source pixels.  Every comparison is on bytes and
exact."""

import zlib

import numpy as np
import pytest

from debigulator_tpu.models import pipeline as jax_pl
from debigulator_tpu_torch.models import bmp_codec, png_codec
from debigulator_tpu_torch.models import pipeline as pl
from debigulator_tpu_torch.parallel.mesh import make_mesh
from torch_png_cases import corpus, corrupt, make_case
from torch_stream_cases import ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


def test_corpus_matches_jax_and_source(monkeypatch):
    monkeypatch.setenv("DBG_FORCE_FUSED_PNG", "1")
    pngs, rgbas = corpus()
    got = pl.decode_png_corpus_device(pngs, device="cpu")
    want = jax_pl.decode_png_corpus_device(pngs)
    for g, w, src in zip(got, want, rgbas, strict=True):
        assert np.array_equal(g, src)
        assert np.array_equal(g, np.asarray(w))


def test_corpus_device_resident_outputs(monkeypatch):
    monkeypatch.setenv("DBG_FORCE_FUSED_PNG", "1")
    pngs, rgbas = corpus()
    got = pl.decode_png_corpus_device(pngs, as_numpy=False, device="cpu")
    want = jax_pl.decode_png_corpus_device(pngs, as_numpy=False)
    for g, w, png, src in zip(got, want, pngs, rgbas, strict=True):
        info = png_codec.parse_chunks(png).info
        assert g.device.type == "cpu" and g.dtype.is_floating_point is False
        # RGB is already widened; palette and gray wait for the host.
        width = 4 * info.width if info.color_type in (2, 6) else info.stride
        assert tuple(g.shape) == (info.height, width)
        assert np.array_equal(g.numpy(), np.asarray(w))
        if info.color_type in (2, 6):
            assert np.array_equal(g.numpy().reshape(src.shape), src)


def test_corpus_chunks_under_a_small_cap(monkeypatch):
    """With the literal-row cap shrunk, the corpus splits into several
    merged calls and one stream decodes alone; results are unchanged."""
    pngs, rgbas = corpus()
    calls = []
    real = pl.build_merged_plan

    def spy(streams, scanned=None):
        calls.append(len(streams))
        return real(streams, scanned=scanned)

    monkeypatch.setattr(pl, "build_merged_plan", spy)
    big, big_rgba = make_case(6, 40, 200, seed=8)
    monkeypatch.setattr(pl, "LIT_ROW_CAP", 512)
    got = pl.decode_png_corpus_device(pngs + [big], device="cpu")
    assert len(calls) >= 2 and sum(calls) == len(pngs)  # big went alone
    for g, src in zip(got, rgbas + [big_rgba], strict=True):
        assert np.array_equal(g, src)


def test_batch_matches_jax_and_source():
    pngs, rgbas = corpus()
    got = pl.decode_png_batch(pngs, device="cpu")
    want = jax_pl.decode_png_batch(pngs)
    for g, w, src in zip(got, want, rgbas, strict=True):
        assert np.array_equal(g, src)
        assert np.array_equal(g, np.asarray(w))
    mesh = make_mesh(dp=2, devices=["cpu"] * 2)  # 7 images padded to 8
    for g, src in zip(pl.decode_png_batch(pngs, mesh=mesh, device="cpu"),
                      rgbas, strict=True):
        assert np.array_equal(g, src)


def test_decode_corpus_isolates_failures_and_resumes(tmp_path):
    import gzip

    png, rgba = make_case(6, 10, 8, seed=4)
    text = b"corpus member " * 400
    files = {"a.png": png, "bad.png": corrupt("crc"),
             "t.gz": gzip.compress(text), "b.bmp": bmp_codec.encode_bmp(rgba),
             "note.txt": b"?"}
    for name, blob in files.items():
        (tmp_path / name).write_bytes(blob)
    paths = [tmp_path / n for n in files]
    man = tmp_path / "manifest.jsonl"
    res = {r.name: r for r in pl.decode_corpus(paths, device="cpu",
                                               manifest_path=str(man))}
    assert np.array_equal(res["a.png"].data, rgba)
    assert res["t.gz"].data == text
    assert np.array_equal(res["b.bmp"].data, rgba)
    assert not res["bad.png"].good and "PngError" in res["bad.png"].error
    assert not res["note.txt"].good and res["note.txt"].error == "unknown format"
    # A restarted job skips what completed and retries what failed.
    (tmp_path / "bad.png").write_bytes(png)
    again = {r.name: r for r in pl.decode_corpus(paths, device="cpu",
                                                 manifest_path=str(man))}
    assert again["a.png"].good and again["a.png"].data is None
    assert again["a.png"].error == "skipped: already completed"
    assert again["bad.png"].good and np.array_equal(again["bad.png"].data, rgba)
    from debigulator_tpu.utils.manifest import JobManifest

    assert JobManifest(str(man)).entry("t.gz")["crc32"] == zlib.crc32(text)
