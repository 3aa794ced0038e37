"""The port's repo-root tools (trace_v15, profile_r3, profile_encoder,
profile_corpus, check_4k_unfilter) and their synthetic inputs
(debigulator_tpu_torch/tools/inputs.py), on device="cpu" at small sizes:
each tool's function returns its numbers and passes its own exactness
check, each main runs once, the inputs keep their pinned bytes, and the
4096^2 check's image decodes like the JAX package's decoder and the
pixel-stepping unfilter oracle.  (The profile_r3 batch's v13 body is held
against the JAX package's in tests/test_torch_drivers.py::test_inflate_v13.)"""

import gzip
import hashlib
import zlib

import numpy as np
import pytest
import torch

from debigulator_tpu.models.png_codec import decode_png as ref_decode_png
from debigulator_tpu_torch.models.pipeline import decode_png_device
from debigulator_tpu_torch.ops.unfilter import unfilter_image
from debigulator_tpu_torch.tools import (
    check_4k_unfilter,
    inputs,
    profile_corpus,
    profile_encoder,
    profile_r3,
    trace_v15,
)

#: The OBJ text's prefix the small batches compress.
SMALL_TEXT = 20_000
#: Intra-op threads while this file runs: its tensors are small, and with
#: one thread a core each of the suite's parallel workers runs many times
#: slower as they contend.
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def small_streams(k: int) -> list[bytes]:
    return inputs.make_streams(inputs.obj_text(size=SMALL_TEXT), k)


def small_corpus() -> list[tuple[bytes, np.ndarray]]:
    """Two PNGs, RGBA and palette with tRNS, made as make_corpus makes its
    images: (PNG, expected RGBA)."""
    rng = np.random.default_rng(3)
    pix = inputs.smooth_pixels(rng, 24, 20, 4)
    out = [(inputs.make_png(pix, 6, 6)[0], pix)]
    pal = inputs.smooth_pixels(rng, 13, 17, 1)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    trns = rng.integers(0, 256, 64, dtype=np.uint8)
    out.append((inputs.make_png(pal, 3, 9, palette, trns)[0],
                inputs.to_rgba(pal, 3, palette, trns)))
    return out


def test_obj_text_and_streams_keep_their_bytes():
    text = inputs.obj_text()
    assert len(text) == inputs.BASE_BYTES == 561_872
    assert hashlib.sha256(text).hexdigest() == (
        "928a27dc75d72cdb6a3aaea76f5a3ff85184b1cbe6c903f07e6018bea9ec3fee")
    streams = inputs.make_streams(text, inputs.N_STREAMS)
    assert len(streams) == 29
    for i, s in enumerate(streams):
        rot = (i * 40961) % len(text)
        assert zlib.decompress(s, -15) == text[rot:] + text[:rot]
    assert inputs.obj_text(size=SMALL_TEXT) == text[:SMALL_TEXT]


def test_k4_png_shape_and_chunks():
    png, raw, pix = inputs.k4_png(40, 24)
    assert pix.shape == (40, 24, 4) and len(raw) == 40 * (1 + 24 * 4)
    assert raw[:: 1 + 24 * 4] == bytes([0, 1, 2, 3, 4] * 8)
    assert (pix[::3] == pix[0]).all() and (pix[:, ::2, 1] == 77).all()
    assert png.startswith(inputs.PNG_SIGNATURE)
    chunks, i = [], 8
    while i < len(png):
        n = int.from_bytes(png[i : i + 4], "big")
        chunks.append((png[i + 4 : i + 8], png[i + 8 : i + 8 + n]))
        i += 12 + n
    assert [t for t, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    assert zlib.decompress(chunks[1][1]) == raw


def test_k4_png_decodes_like_the_reference():
    png, raw, pix = inputs.k4_png(40, 24)
    assert np.array_equal(ref_decode_png(png), pix)
    got = decode_png_device(png, device="cpu")
    assert np.array_equal(got, pix)
    oracle = unfilter_image(np.frombuffer(raw, np.uint8), 40, 24, 4)
    assert np.array_equal(oracle, got.reshape(40, 24 * 4))


def test_trace_v15_on_two_streams():
    r = trace_v15.trace(small_streams(2), device="cpu")
    assert r["out_bytes"] == 2 * SMALL_TEXT and r["device_ms"] > 0
    names = {name for _, name in r["top_ops"]}
    assert {"phase_a_huffman", "phase_b_lz77"} <= names
    assert r["kernels"] == []  # a CPU trace holds no CUDA kernel


def test_profile_r3_on_two_copies():
    r = profile_r3.profile(small_streams(1) * 2, device="cpu", reps=1)
    assert r["bit_exact"] and not r["overflow"]
    assert r["out_bytes"] == 2 * SMALL_TEXT and r["n_seg"] == 1
    assert min(r["host_plan_ms"], r["stage_ms"], r["phase_a_ms"],
               r["v13_ms"]) > 0


def test_profile_r3_raises_on_a_wrong_decode(monkeypatch):
    from debigulator_tpu_torch.ops import inflate as inf

    real = inf.inflate_v13

    def corrupt(*args):
        body, overflow = real(*args)
        body = body.clone()
        body[7] += 1
        return body, overflow

    monkeypatch.setattr(inf, "inflate_v13", corrupt)
    with pytest.raises(AssertionError, match="bit-exact"):
        profile_r3.profile(small_streams(1), device="cpu", reps=1)


def test_profile_encoder_on_a_32x32_crop():
    pix = inputs.smooth_pixels(np.random.default_rng(0), 32, 32, 4)
    r = profile_encoder.profile(pix, device="cpu", host_crop=32)
    d, h = r["device"], r["host"]
    assert d["filtered_bytes"] == h["filtered_bytes"] == 32 * (1 + 32 * 4)
    assert d["tokens"] > d["matches"] > 0 and d["deflate_bytes"] > 0
    assert 0 < h["match_lengths_ms"] <= h["lz77_parse_ms"]
    assert h["crop"] == "32x32 at (0, 0)" and h["deflate_bytes"] > 0
    assert profile_encoder.host_phases(pix, 16)["crop"] == "16x16 at (8, 8)"


def test_profile_corpus_on_two_images():
    r = profile_corpus.profile(small_corpus(), device="cpu", traced=True)
    assert r["images"] == 2 and r["exact"]
    assert len(r["numpy_ms"]) == len(r["device_resident_ms"]) == 2
    assert r["rgba_bytes"] == (24 * 20 + 13 * 17) * 4
    assert r["top_ops"] and r["kernels"] == []


def test_profile_corpus_raises_on_wrong_pixels():
    (png, pix), other = small_corpus()
    bad = pix.copy()
    bad[0, 0, 0] ^= 1
    with pytest.raises(AssertionError, match="image 0"):
        profile_corpus.profile([(png, bad), other], device="cpu")


@pytest.mark.parametrize("seed", [1, 2])
def test_check_4k_unfilter_small(seed):
    png, raw, pix = inputs.k4_png(40, 24, seed)
    r = check_4k_unfilter.check(png, raw, pix, device="cpu")
    assert r["exact"] and r["rgba_bytes"] == 40 * 24 * 4


def test_check_4k_oracle_sees_a_wrong_row():
    _, raw, pix = inputs.k4_png(40, 24)
    check_4k_unfilter.oracle_check(raw, pix)
    bad = pix.copy()
    bad[30, 5, 2] ^= 1
    with pytest.raises(AssertionError, match="from the oracle from row 30 on"):
        check_4k_unfilter.oracle_check(raw, bad)


def _main_args(tool, tmp_path):
    if tool == "trace_v15":
        return ["1", "--no-trace"]
    if tool == "profile_r3":
        f = tmp_path / "s.gz"
        f.write_bytes(gzip.compress(inputs.obj_text(size=SMALL_TEXT)))
        return ["2", "--stream", str(f), "--reps", "1"]
    if tool == "profile_encoder":
        f = tmp_path / "a.png"
        f.write_bytes(small_corpus()[0][0])
        return [str(f), "--host-crop", "16"]
    if tool == "profile_corpus":
        files = []
        for k, (png, _) in enumerate(small_corpus()):
            files.append(tmp_path / f"{k}.png")
            files[-1].write_bytes(png)
        return [*map(str, files), "--trace"]
    return ["--side", "24"]


#: tool -> a line its main prints on a run that held.
MAIN_PRINTS = {"trace_v15": "device/batch", "profile_r3": "bit-exact: True",
               "profile_encoder": "host encoder, crop 16x16",
               "profile_corpus": "every image exact",
               "check_4k_unfilter": "decode OK, bit-exact"}


@pytest.mark.parametrize("tool", sorted(MAIN_PRINTS))
def test_main_runs_on_the_cpu(tool, tmp_path, capsys):
    module = {"trace_v15": trace_v15, "profile_r3": profile_r3,
              "profile_encoder": profile_encoder,
              "profile_corpus": profile_corpus,
              "check_4k_unfilter": check_4k_unfilter}[tool]
    assert module.main([*_main_args(tool, tmp_path), "--device", "cpu"]) == 0
    assert MAIN_PRINTS[tool] in capsys.readouterr().out
