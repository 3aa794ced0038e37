"""The PyTorch port stands alone: importing any of its modules pulls in
neither JAX nor the JAX package, and its entry points default to the card
(they raise on a host without CUDA instead of running on the CPU)."""

import subprocess
import sys
import zlib

import pytest
import torch

MODULES = [
    "debigulator_tpu_torch",
    "debigulator_tpu_torch.constants",
    "debigulator_tpu_torch.device",
    "debigulator_tpu_torch.native",
    "debigulator_tpu_torch.native.scanner",
    "debigulator_tpu_torch.ops.checksum",
    "debigulator_tpu_torch.ops.deflate_encode",
    "debigulator_tpu_torch.ops.deflate_encode_device",
    "debigulator_tpu_torch.ops.graph",
    "debigulator_tpu_torch.ops.huffman",
    "debigulator_tpu_torch.ops.inflate",
    "debigulator_tpu_torch.ops.inflate_ref",
    "debigulator_tpu_torch.ops.lz77",
    "debigulator_tpu_torch.ops.phase_a",
    "debigulator_tpu_torch.ops.phase_b",
    "debigulator_tpu_torch.ops.plan",
    "debigulator_tpu_torch.ops.scanner",
    "debigulator_tpu_torch.ops.unfilter",
    "debigulator_tpu_torch.ops._kernels",
    "debigulator_tpu_torch.models.bmp_codec",
    "debigulator_tpu_torch.models.gzip_codec",
    "debigulator_tpu_torch.models.pipeline",
    "debigulator_tpu_torch.models.png_codec",
    "debigulator_tpu_torch.models.zlib_codec",
    "debigulator_tpu_torch.parallel.merged",
    "debigulator_tpu_torch.tools.first_call",
    "debigulator_tpu_torch.utils.logging",
    "debigulator_tpu_torch.utils.manifest",
]

_CHECK = """
import sys, zlib
for m in {mods!r}:
    __import__(m)
import numpy as np
from debigulator_tpu_torch.ops.inflate import inflate_device
from debigulator_tpu_torch.models.pipeline import decode_png_device
from debigulator_tpu_torch.models.png_codec import encode_png
data = b"standalone " * 500
c = zlib.compressobj(6, zlib.DEFLATED, -15)
raw = c.compress(data) + c.flush()
assert inflate_device(raw, device="cpu") == data
assert inflate_device(raw, device="cpu", use_kernels=False) == data
img = np.arange(9 * 7 * 4, dtype=np.uint8).reshape(9, 7, 4) // 8
assert (decode_png_device(encode_png(img, device="cpu"), device="cpu") == img).all()
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k == "debigulator_tpu" or k.startswith("debigulator_tpu."))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _CHECK.format(mods=MODULES)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def _entry_calls():
    """Every public entry point of the port, called with its default
    device."""
    import gzip

    import numpy as np

    from debigulator_tpu_torch.models import pipeline as pl
    from debigulator_tpu_torch.models.png_codec import encode_png
    from debigulator_tpu_torch.models.zlib_codec import encode_zlib
    from debigulator_tpu_torch.ops import deflate_encode_device as dev
    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.parallel.merged import decode_merged

    data = b"default device " * 100
    arr = np.frombuffer(data, np.uint8)
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = c.compress(data) + c.flush()
    img = np.zeros((4, 4, 4), np.uint8)
    png = encode_png(img, device="cpu")
    return {
        "decode_merged": lambda: decode_merged([raw]),
        "decode_gzip_device": lambda: pl.decode_gzip_device(gzip.compress(data)),
        "inflate_device": lambda: inf.inflate_device(raw),
        "inflate_device_dev": lambda: inf.inflate_device_dev(raw),
        "decode_png_device": lambda: pl.decode_png_device(png),
        "decode_png_corpus_device": lambda: pl.decode_png_corpus_device([png]),
        "decode_png_batch": lambda: pl.decode_png_batch([png]),
        "decode_corpus": lambda: pl.decode_corpus([]),
        "encode_png": lambda: encode_png(img),
        "encode_zlib": lambda: encode_zlib(data),
        "deflate_fixed_device": lambda: dev.deflate_fixed_device(data),
        "lz77_parse_device": lambda: dev.lz77_parse_device(arr),
        "lz77_parse_device_short": lambda: dev.lz77_parse_device(arr[:5]),
        "lz77_select_device": lambda: dev.lz77_select_device(arr),
    }


@pytest.mark.parametrize("entry", [
    "decode_merged", "decode_gzip_device", "inflate_device",
    "inflate_device_dev", "decode_png_device", "decode_png_corpus_device",
    "decode_png_batch", "decode_corpus", "encode_png", "encode_zlib",
    "deflate_fixed_device", "lz77_parse_device", "lz77_parse_device_short",
    "lz77_select_device"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_calls()[entry]()


def test_kernel_wrappers_raise_without_card():
    """A CUDA-only wrapper path must never fall back: asking the launcher
    for a kernel with CPU tensors is refused."""
    from debigulator_tpu_torch.ops import _kernels

    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.launch("dbg_walk", torch.zeros(4, dtype=torch.int32))


def test_new_kernel_wrappers_refuse_cpu_pointers():
    """The two wrappers of this slice take the plain version only for CPU
    tensors; the launcher itself never accepts one."""
    from debigulator_tpu_torch.ops import _kernels

    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.launch("dbg_unfilter", torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.launch("dbg_greedy_walk", torch.zeros(4, dtype=torch.int32))
    assert set(_kernels.SOURCES) == {
        lib for lib, _ in _kernels._ENTRIES.values()}
    for src in _kernels.SOURCES.values():
        assert (_kernels.CSRC / src).is_file()
    for lib, headers in _kernels.HEADERS.items():
        text = (_kernels.CSRC / _kernels.SOURCES[lib]).read_text()
        for h in headers:
            assert (_kernels.CSRC / h).is_file() and f'#include "{h}"' in text


@pytest.mark.parametrize("wrapper", ["phase_a_tape", "resolve_matches_v4",
                                     "resolve_tape_v6", "resolve_ops_v13"])
def test_fallback_kernel_wrappers_count_launches_only_on_the_card(wrapper):
    """On CPU tensors a wrapper runs its plain version and its launch
    count stays where it was."""
    from debigulator_tpu_torch.ops import lz77, phase_a, plan

    fn = getattr(phase_a if wrapper == "phase_a_tape" else lz77, wrapper)
    before = fn.launches
    z = torch.zeros((300, 128), dtype=torch.int32)
    lst = torch.zeros((8, 128), dtype=torch.int32)
    if wrapper == "phase_a_tape":
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        raw = c.compress(b"count " * 300) + c.flush()
        from debigulator_tpu_torch.ops.scanner import scan_stream_cells
        blocks, lengths, cells = scan_stream_cells(raw, plan.CELL_BITS)
        p = plan.build_plan_v3(raw, blocks, lengths, cells=cells)
        inp = phase_a.stage_phase_a_inputs(phase_a.build_phase_a_inputs(p),
                                           torch.device("cpu"))
        fn(inp, p.slots)
    elif wrapper == "resolve_matches_v4":
        fn(z, lst, lst)
    elif wrapper == "resolve_tape_v6":
        fn(z, lst, lst[:1], lst[:1], 0, 64, 0, 8)
    else:
        fn(z, lst, lst, lst, lst, lst, lst[:1], lst[:1], 0, 64, 0, 8)
    assert fn.launches == before


def _c_params(entry: str) -> list[str]:
    """Parameter declarations of an extern "C" entry in csrc/*.cu."""
    import re

    from debigulator_tpu_torch.ops import _kernels

    lib = _kernels._ENTRIES[entry][0]
    src = (_kernels.CSRC / _kernels.SOURCES[lib]).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, f"{entry} not found in {lib}"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("entry", ["dbg_phase_a", "dbg_compact", "dbg_walk",
                                   "dbg_unfilter", "dbg_greedy_walk",
                                   "dbg_phase_a_tape", "dbg_lz77_match",
                                   "dbg_lz77_tape_place", "dbg_lz77_tape_walk",
                                   "dbg_lz77_ops_place", "dbg_lz77_ops_walk"])
def test_ctypes_declarations_match_c_entries(entry):
    """ctypes cannot check a call against the C prototype: a missing or
    mistyped argument shifts every later one (and the stream).  Hold the
    Python declarations against the sources."""
    import ctypes

    from debigulator_tpu_torch.ops import _kernels

    params = _c_params(entry)
    argtypes = _kernels._ENTRIES[entry][1]
    assert params[-1].startswith("cudaStream_t")
    assert len(params) == len(argtypes) + 1
    for decl, at in zip(params, argtypes):
        if "*" in decl:
            assert at is ctypes.c_void_p, decl
        elif decl.startswith("int64_t"):
            assert at is ctypes.c_int64, decl
        else:
            assert decl.startswith("int ") and at is ctypes.c_int, decl
