"""The port's layer spans (``utils/profiling.named_scope``) on device="cpu":
each decode entry opens a span at every host layer, nested in its request
span on the caller's thread, under ``torch.profiler``; with no profiler no
span is recorded and the bytes are the same; the ``[dbg]`` lines of
-v (one summary a call) and -vv (one line a span) come from the same
spans."""

import collections
import functools
import gzip
import json
import re

import numpy as np
import pytest
import torch

from debigulator_tpu_torch.cli import cuda_gz, cuda_png
from debigulator_tpu_torch.models import pipeline as pl
from debigulator_tpu_torch.ops import plan as tp
from debigulator_tpu_torch.utils import config, profiling
from torch_png_cases import make_case, make_png

#: The layer spans of each decode entry's main thread.
GZIP_SPANS = {"dbg.parse", "dbg.scan", "dbg.plan", "dbg.stage",
              "dbg.stage.pack", "dbg.stage.h2d", "dbg.check", "dbg.readback"}
PNG_SPANS = GZIP_SPANS | {"dbg.unfilter"}
CORPUS_SPANS = {"dbg.parse", "dbg.scan", "dbg.plan", "dbg.plan.wait",
                "dbg.check", "dbg.unfilter", "dbg.readback"}
#: The layers of a gzip call's -v summary line.
GZIP_LAYERS = ("parse", "scan", "plan", "stage", "check", "readback",
               "phase_a_huffman", "phase_b_lz77", "v15_prep", "v15_compact",
               "v15_walk")


@functools.cache
def gzip_file():
    """(three-member gzip file, its text)."""
    text = b"".join(b"line %d of the text, %d\n" % (i, i * 7 % 13)
                    for i in range(3000))
    parts = (text[:20_000], text[20_000:50_000], text[50_000:])
    return b"".join(gzip.compress(p, 6) for p in parts), text


@functools.cache
def long_png():
    """(PNG whose IDAT stream holds 5 blocks, its RGBA)."""
    pix = np.random.RandomState(3).randint(0, 16, (64, 480, 4))
    return make_png(pix.astype(np.uint8), 6, seed=3), pix


def decode(case, monkeypatch):
    """Run ``case``'s entry on the CPU: (request span, output bytes)."""
    if case == "gzip":
        return "dbg.decode_gzip", pl.decode_gzip_device(gzip_file()[0],
                                                        device="cpu")
    if case == "png":
        png, _ = make_case(6, 24, 40, seed=5)
        return "dbg.decode_png", pl.decode_png_device(png, device="cpu").tobytes()
    if case == "png_long":
        # Under a small literal-row cap the stream is too large for one
        # call and decodes in block-aligned chunks.
        monkeypatch.setattr(tp, "LIT_ROW_CAP", 1024)
        return "dbg.decode_png", pl.decode_png_device(long_png()[0],
                                                      device="cpu").tobytes()
    pngs = [make_case(ct, 12, 9, seed=ct)[0] for ct in (6, 2, 3)]
    out = pl.decode_png_corpus_device(pngs, device="cpu")
    return "dbg.decode_png_corpus", b"".join(a.tobytes() for a in out)


def traced(case, monkeypatch, tmp_path):
    """(request span name, output, the main thread's spans as (name, start,
    end) in start order) of one call under a CPU profiler."""
    with profiling.device_trace(str(tmp_path), device="cpu"):
        request, out = decode(case, monkeypatch)
    (path,) = tmp_path.glob("*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (req,) = [e for e in events if e["name"] == request]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e["tid"] == req["tid"]]
    return request, out, sorted(spans, key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("case,want", [
    ("gzip", GZIP_SPANS), ("png", PNG_SPANS), ("png_long", PNG_SPANS),
    ("corpus", CORPUS_SPANS)])
def test_every_layer_span_nests_in_the_request(case, want, monkeypatch,
                                               tmp_path):
    request, _, spans = traced(case, monkeypatch, tmp_path)
    names = collections.Counter(name for name, _, _ in spans)
    assert want <= set(names)
    (req,) = [s for s in spans if s[0] == request]
    for s in spans:
        if s[0].startswith("dbg.") and s is not req:
            assert _inside(s, req), s
    if case == "gzip":  # a member: parse, scan, parse, check
        assert (names["dbg.parse"], names["dbg.scan"], names["dbg.check"]) \
            == (6, 3, 3)
    if case.startswith("png"):
        # Each chunk's CRC-32 (IHDR, tEXt, IDAT..., IEND) inside the
        # parse; the size check and Adler-32 after it.
        parses = [s for s in spans if s[0] == "dbg.parse"]
        checks = [s for s in spans if s[0] == "dbg.check"]
        crcs = [c for c in checks if any(_inside(c, p) for p in parses)]
        assert len(crcs) >= 4 and len(checks) == len(crcs) + 1
    if case == "png_long":
        # The whole stream's plan, the chunking, then one a chunk.
        assert names["dbg.plan"] >= 4
        assert names["phase_a_huffman"] == names["dbg.plan"] - 2


@pytest.mark.parametrize("case", ["gzip", "png", "png_long", "corpus"])
def test_no_profiler_records_no_span(case, monkeypatch, tmp_path):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    _, out = decode(case, monkeypatch)
    assert entered == []
    _, out_traced, _ = traced(case, monkeypatch, tmp_path)
    assert entered and out_traced == out
    if case == "gzip":
        assert out == gzip_file()[1]
    if case == "png_long":
        assert out == long_png()[1].astype(np.uint8).tobytes()


def _dbg_lines(err: str) -> list[str]:
    return [line for line in err.splitlines() if line.startswith("[dbg] ")]


def test_verbose_summary_line_a_call(monkeypatch, capsys):
    monkeypatch.delenv("DBG_VERBOSITY", raising=False)
    monkeypatch.setattr(config.get_config(), "verbosity", 1)
    data, text = gzip_file()
    for _ in range(2):
        assert pl.decode_gzip_device(data, device="cpu") == text
    lines = _dbg_lines(capsys.readouterr().err)
    assert len(lines) == 2
    for line in lines:
        fields = dict(kv.split("=") for kv in line.split()[2:])
        assert line.split()[1] == "decode_gzip"
        assert {f"{k}_ms" for k in GZIP_LAYERS} | {"total_ms", "other_ms"} \
            == set(fields)
        # The layers' self times and the request's own add up to its length.
        parts = sum(float(v) for k, v in fields.items() if k != "total_ms")
        assert parts == pytest.approx(float(fields["total_ms"]), abs=0.02)
    monkeypatch.setattr(config.get_config(), "verbosity", 0)
    pl.decode_gzip_device(data, device="cpu")
    assert _dbg_lines(capsys.readouterr().err) == []


@pytest.mark.parametrize("case", ["gzip", "png"])
def test_very_verbose_line_a_span(case, monkeypatch, capsys, tmp_path):
    """At -vv every span the profiler records on the main thread also
    writes one line as it closes, then the request its summary."""
    monkeypatch.delenv("DBG_VERBOSITY", raising=False)
    monkeypatch.setattr(config.get_config(), "verbosity", 2)
    request, _, spans = traced(case, monkeypatch, tmp_path)
    lines = _dbg_lines(capsys.readouterr().err)
    assert lines[-1].split()[1] == request[4:]
    assert lines[-2].split()[1] == request
    logged = collections.Counter(line.split()[1] for line in lines[:-1])
    assert logged == collections.Counter(name for name, _, _ in spans)
    for line in lines[:-1]:
        assert re.fullmatch(r"\[dbg\] \S+ ms=[\d.]+ self_ms=-?[\d.]+", line)


def test_cli_verbose_lines_come_from_the_spans(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("DBG_VERBOSITY", raising=False)
    monkeypatch.setattr(config.get_config(), "verbosity", 0)
    data, text = gzip_file()
    src = tmp_path / "t.gz"
    src.write_bytes(data)
    out = tmp_path / "t"
    assert cuda_gz.main(["-v", "decode", str(src), "-o", str(out),
                         "--device", "cpu", "--repeat", "2"]) == 0
    assert out.read_bytes() == text
    lines = _dbg_lines(capsys.readouterr().err)
    assert [line.split()[1] for line in lines] == ["decode_gzip"] * 2
    png, _ = make_case(2, 10, 12, seed=1)
    (tmp_path / "a.png").write_bytes(png)
    assert cuda_png.main(["-vv", "decode", str(tmp_path / "a.png"),
                          "--device", "cpu"]) == 0
    lines = _dbg_lines(capsys.readouterr().err)
    names = [line.split()[1] for line in lines]
    assert names[-1] == "decode_png" and names[-2] == "dbg.decode_png"
    assert PNG_SPANS <= set(names)
