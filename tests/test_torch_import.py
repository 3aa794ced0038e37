"""The PyTorch port stands alone: importing any of its modules pulls in
neither JAX nor the JAX package, and its entry points default to the card
(they raise on a host without CUDA instead of running on the CPU)."""

import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch


def _walk_modules() -> list[str]:
    """Every module of the port, found by walking the package."""
    import pkgutil

    import debigulator_tpu_torch

    return ["debigulator_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(debigulator_tpu_torch.__path__,
                                              "debigulator_tpu_torch."))


MODULES = _walk_modules()

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
from debigulator_tpu_torch.tools.profile_merged import profile
assert profile([raw], device="cpu", reps=1)["out_bytes"] == len(data)
from debigulator_tpu_torch.parallel.batch import decode_batch_device
from debigulator_tpu_torch.parallel.mesh import make_mesh
from debigulator_tpu_torch.parallel.split_stream import decode_split_stream
assert decode_batch_device([raw], device="cpu") == [data]
big = data * 10
c = zlib.compressobj(6, zlib.DEFLATED, -15)
assert decode_split_stream(c.compress(big) + c.flush(),
                           mesh=make_mesh(sp=2, devices=["cpu"] * 2),
                           seg_bytes=32768) == big
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k == "debigulator_tpu" or k.startswith("debigulator_tpu."))
print("BAD", bad)
"""


def test_module_walk_covers_every_source_file():
    """The walk finds each .py file of the package (new ones included) and
    every module the hand-kept list of earlier slices named."""
    import pathlib

    import debigulator_tpu_torch

    root = pathlib.Path(debigulator_tpu_torch.__file__).parent
    files = {".".join(("debigulator_tpu_torch",) + p.relative_to(root)
                      .with_suffix("").parts).removesuffix(".__init__")
             for p in root.rglob("*.py") if "build" not in p.parts}
    assert files == set(MODULES)
    assert {"debigulator_tpu_torch.parallel.multihost",
            "debigulator_tpu_torch.cli.cuda_gz",
            "debigulator_tpu_torch.utils.sanitize",
            "debigulator_tpu_torch.tools.event_chase"} <= files


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
    from debigulator_tpu_torch.ops.archive import host_fed
    from debigulator_tpu_torch.parallel import batch, split_stream
    from debigulator_tpu_torch.parallel.merged import (
        build_merged_plan,
        decode_merged,
    )
    from debigulator_tpu_torch.parallel.mesh import make_mesh
    from debigulator_tpu_torch.tools import (
        check_4k_unfilter,
        event_chase,
        microbench_pb,
        profile_corpus,
        profile_encoder,
        profile_merged,
        profile_r3,
        trace_v15,
    )

    import tempfile
    from pathlib import Path

    from debigulator_tpu_torch.cli import cuda_gz, cuda_png
    from debigulator_tpu_torch.utils import profiling

    data = b"default device " * 100
    arr = np.frombuffer(data, np.uint8)
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = c.compress(data) + c.flush()
    img = np.zeros((4, 4, 4), np.uint8)
    png = encode_png(img, device="cpu")
    tmp = Path(tempfile.mkdtemp())
    gz_path, png_path, raw_path = tmp / "a.gz", tmp / "a.png", tmp / "a.raw"
    gz_path.write_bytes(gzip.compress(data))
    png_path.write_bytes(png)
    img.tofile(raw_path)
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
        # encode_zlib's own default is the host encoder; the device encoder
        # it reaches through deflate_fn defaults to the card.
        "encode_zlib": lambda: encode_zlib(
            data, deflate_fn=dev.deflate_fixed_device),
        "deflate_fixed_device": lambda: dev.deflate_fixed_device(data),
        "lz77_parse_device": lambda: dev.lz77_parse_device(arr),
        "lz77_parse_device_short": lambda: dev.lz77_parse_device(arr[:5]),
        "lz77_select_device": lambda: dev.lz77_select_device(arr),
        "build_v9_arrays": lambda: host_fed.build_v9_arrays(
            build_merged_plan([raw], records=True), 1),
        "profile_merged": lambda: profile_merged.profile([raw]),
        "host_fed_inputs": lambda: profile_merged.host_fed_inputs([raw]),
        "build_group_arrays_v10": lambda: host_fed.build_group_arrays_v10(
            build_merged_plan([raw], records=True).recs, 1),
        "literal_runs": lambda: host_fed.literal_runs(
            build_merged_plan([raw], records=True).recs),
        "microbench_pb": microbench_pb.main,
        "trace_v15": lambda: trace_v15.main([]),
        "profile_encoder": lambda: profile_encoder.main([]),
        "profile_corpus": lambda: profile_corpus.main([]),
        "check_4k_unfilter": lambda: check_4k_unfilter.main([]),
        "profile_r3": lambda: profile_r3.main([]),
        "event_chase": event_chase.main,
        "make_mesh": make_mesh,
        "decode_batch_device": lambda: batch.decode_batch_device([raw]),
        "decode_split_emulated": lambda: split_stream.decode_split_emulated(
            raw, 2),
        "decode_split_stream": lambda: split_stream.decode_split_stream(raw),
        "device_trace": lambda: profiling.device_trace(
            str(tmp / "trace")).__enter__(),
        "cuda_gz": lambda: cuda_gz.main(["decode", str(gz_path), "-o",
                                         str(tmp / "out")]),
        "cuda_png_decode": lambda: cuda_png.main(["decode", str(png_path)]),
        "cuda_png_encode": lambda: cuda_png.main(
            ["encode", str(raw_path), "4x4", "-o", str(tmp / "o.png")]),
    }


@pytest.mark.parametrize("entry", [
    "decode_merged", "decode_gzip_device", "inflate_device",
    "inflate_device_dev", "decode_png_device", "decode_png_corpus_device",
    "decode_png_batch", "decode_corpus", "encode_png", "encode_zlib",
    "deflate_fixed_device", "lz77_parse_device", "lz77_parse_device_short",
    "lz77_select_device", "build_v9_arrays", "profile_merged",
    "host_fed_inputs", "build_group_arrays_v10", "literal_runs",
    "microbench_pb", "trace_v15", "profile_encoder", "profile_corpus",
    "check_4k_unfilter", "profile_r3", "event_chase", "make_mesh",
    "decode_batch_device",
    "decode_split_emulated", "decode_split_stream", "device_trace", "cuda_gz",
    "cuda_png_decode", "cuda_png_encode"])
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
                                   "dbg_lz77_tape_place", "dbg_lz77_tape_chase",
                                   "dbg_lz77_ops_place", "dbg_lz77_ops_chase",
                                   "dbg_lz77_tape_v1_len",
                                   "dbg_groups_v11_lits",
                                   "dbg_groups_v11_chase", "dbg_compact_v14",
                                   "dbg_walk_v14_runs", "dbg_walk_v14_chase",
                                   "dbg_groups_v10_lits",
                                   "dbg_groups_v9_chase", "dbg_microbench_pb",
                                   "dbg_microbench_chase"])
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


@pytest.mark.parametrize("entry", ["dbg_greedy_chunk", "dbg_greedy_starts",
                                   "dbg_phase_a_lut_bits"])
def test_constant_entries_take_nothing(entry):
    """A constant of a kernel's layout is read by calling its C entry with
    no arguments (and no stream): the source must declare it so."""
    from debigulator_tpu_torch.ops import _kernels

    lib = _kernels._CONSTANTS[entry]
    src = (_kernels.CSRC / _kernels.SOURCES[lib]).read_text()
    assert f'extern "C" int {entry}() {{' in src
    assert entry not in _kernels._ENTRIES


def _archive_calls():
    """Each archive wrapper on small CPU inputs."""
    from debigulator_tpu_torch.ops.archive import lz77_generations as lg

    buf = torch.zeros((lg.BODY_START // 128 + 8, 128), dtype=torch.int32)
    lim = torch.zeros(8, dtype=torch.int32)
    words = torch.zeros((32, 128), dtype=torch.int32)
    rows = torch.zeros((1, 128), dtype=torch.int32)
    cells = torch.zeros((16, 8), dtype=torch.int32)
    return {
        "resolve_groups_v11": lambda: lg.resolve_groups_v11(
            buf, lim, words, words, words, words, words),
        "compact_v14": lambda: lg.compact_v14(
            words, words, words, words, words, rows, rows, rows, rows, 4, 4,
            16),
        "resolve_walk_v14": lambda: lg.resolve_walk_v14(
            buf, lim, words, words, words, words, words),
        "resolve_tape_v1": lambda: lg.resolve_tape_v1(
            cells, torch.zeros(16, dtype=torch.int32), 0),
        "resolve_matches": lambda: lg.resolve_matches(buf, words, words),
        "resolve_matches_v2": lambda: lg.resolve_matches_v2(buf, words, words),
        "resolve_groups_v9": lambda: lg.resolve_groups_v9(buf, lim, words,
                                                          words),
        "resolve_groups_v10": lambda: lg.resolve_groups_v10(
            buf, lim, words, words, words, words, words),
    }


ARCHIVE_WRAPPERS = ["resolve_groups_v11", "compact_v14", "resolve_walk_v14",
                    "resolve_tape_v1", "resolve_matches", "resolve_matches_v2",
                    "resolve_groups_v9", "resolve_groups_v10"]


@pytest.mark.parametrize("wrapper", ARCHIVE_WRAPPERS)
def test_archive_wrappers_count_launches_only_on_the_card(wrapper):
    """On CPU tensors an archive wrapper runs its plain version and its
    launch count stays where it was; its kernel entries refuse CPU
    tensors, so a CUDA-only path cannot fall back."""
    from debigulator_tpu_torch.ops import _kernels
    from debigulator_tpu_torch.ops.archive import lz77_generations as lg

    fn = getattr(lg, wrapper)
    before = fn.launches
    _archive_calls()[wrapper]()
    assert fn.launches == before
    entries = [e for e, (lib, _) in _kernels._ENTRIES.items()
               if lib in {"resolve_groups_v11": ("groups_v11",),
                          "compact_v14": ("compact_v14",),
                          "resolve_walk_v14": ("walk_v14",),
                          "resolve_tape_v1": ("lz77_tape",),
                          "resolve_matches": ("lz77_match",),
                          "resolve_matches_v2": ("lz77_match",),
                          "resolve_groups_v9": ("groups_v9",),
                          "resolve_groups_v10": ("groups_v9",)}[wrapper]]
    assert entries
    for entry in entries:
        with pytest.raises(ValueError, match="CUDA tensors"):
            _kernels.launch(entry, torch.zeros(4, dtype=torch.int32))


def _archive_card_calls(empty: bool):
    """Each archive wrapper on inputs with nothing to resolve (empty), or
    with the least that makes it launch: literal pieces, cells, one run,
    a tape."""
    from debigulator_tpu_torch.ops.archive import lz77_generations as lg

    i32 = torch.int32
    buf = torch.zeros((lg.BODY_START // 128 + 8, 128), dtype=i32)
    lim = torch.zeros(8, dtype=i32)
    none = torch.zeros((0, 128), dtype=i32)
    words = none if empty else torch.zeros((16, 128), dtype=i32)
    cnt = none if empty else torch.zeros((1, 128), dtype=i32)
    run = torch.tensor([0, 0, 0, 0 if empty else 1, 0, 0, 0, 0], dtype=i32)
    tape = torch.zeros((0 if empty else 16, 8), dtype=i32)
    # One live match piece of 3 bytes at distance 1 in slot range [0, 8).
    one = torch.tensor([0, 8, 0, 0, 0, 0, 0, 0], dtype=i32)
    piece = torch.zeros((0 if empty else 1, 128), dtype=i32)
    piece_meta = piece.clone()
    if not empty:
        piece_meta[0, 0] = (3 << 16) | 1
    return {
        "resolve_groups_v11": lambda: lg.resolve_groups_v11(
            buf, lim, none, none, words, words, words),
        "compact_v14": lambda: lg.compact_v14(
            words, words, words, words, words, cnt, cnt, cnt, cnt, 4, 4, 16),
        "resolve_walk_v14": lambda: lg.resolve_walk_v14(
            buf, lim if empty else run, none, none, words, words, words),
        "resolve_tape_v1": lambda: lg.resolve_tape_v1(
            tape, torch.zeros(tape.shape[0], dtype=i32), 0),
        "resolve_matches": lambda: lg.resolve_matches(buf, words, words),
        "resolve_matches_v2": lambda: lg.resolve_matches_v2(buf, words, words),
        "resolve_groups_v9": lambda: lg.resolve_groups_v9(
            buf, one if not empty else lim, piece, piece_meta),
        "resolve_groups_v10": lambda: lg.resolve_groups_v10(
            buf, lim, none, none, words, words, words),
    }


@pytest.mark.parametrize("empty", [True, False])
@pytest.mark.parametrize("wrapper", ARCHIVE_WRAPPERS)
def test_archive_wrappers_count_only_calls_that_launch(monkeypatch, wrapper,
                                                       empty):
    """The card's branch of each archive wrapper, taken here on CPU
    tensors with the launches recorded instead of made: a call with
    nothing to resolve launches no kernel and leaves the count as it was;
    a call that launches adds one."""
    from debigulator_tpu_torch.ops import _kernels
    from debigulator_tpu_torch.ops.archive import lz77_generations as lg

    made = []
    monkeypatch.setattr(lg, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch", lambda entry, *a: made.append(entry))
    fn = getattr(lg, wrapper)
    before = fn.launches
    _archive_card_calls(empty)[wrapper]()
    assert bool(made) is not empty
    assert fn.launches == before + (not empty)


def _chase_card_calls():
    """The four archive resolvers on a chase, on CPU tensors with literal
    and match pieces (runs and matches) to resolve: one live piece of 3
    bytes at distance 1 in slot range [0, 8), one literal piece; one run
    and one match in the dense lists."""
    from debigulator_tpu_torch.ops.archive import host_fed
    from debigulator_tpu_torch.ops.archive import lz77_generations as lg

    i32 = torch.int32
    buf = torch.zeros((lg.BODY_START // 128 + 8, 128), dtype=i32)
    start = lg.BODY_START

    def words(dst, ln, src):
        w0, w1 = host_fed._pack_piece_words(np.array(dst), np.array(ln),
                                            np.array(src))
        out = torch.zeros((2, 1, 128), dtype=i32)
        out[0, 0, : len(dst)] = torch.from_numpy(w0.astype(np.int32))
        out[1, 0, : len(dst)] = torch.from_numpy(w1.astype(np.int32))
        return out[0], out[1]

    gpos, gmeta = words([start + 1], [3], [start])
    lpos, lmeta = words([start], [1], [128])
    lim = torch.tensor([0, 8, 0, 0, 8, 0, 0, 0], dtype=i32)
    lit = torch.full((1, 128), 7, dtype=i32)
    mdst = torch.tensor([[1] + [0] * 127], dtype=i32)
    mmeta = torch.tensor([[(3 << 16) | 1] + [0] * 127], dtype=i32)
    rdst = torch.zeros((1, 128), dtype=i32)
    rmeta = torch.tensor([[1] + [0] * 127], dtype=i32)
    lims = torch.tensor([0, 1, 0, 1, 0, 0, 0, 0], dtype=i32)
    v9_pos = torch.zeros((1, 128), dtype=i32)
    v9_pos[0, 0] = 1
    v9_lpos = torch.zeros((1, 128), dtype=i32)
    v9_lmeta = torch.zeros((1, 128), dtype=i32)
    v9_lmeta[0, 0] = (1 << 20) | 128
    return {
        "resolve_groups_v11": lambda: lg.resolve_groups_v11(
            buf, lim, gpos, gmeta, lpos, lmeta, lit),
        "resolve_walk_v14": lambda: lg.resolve_walk_v14(
            buf, lims, mdst, mmeta, rdst, rmeta, lit),
        "resolve_groups_v9": lambda: lg.resolve_groups_v9(
            buf, lim, v9_pos, mmeta),
        "resolve_groups_v10": lambda: lg.resolve_groups_v10(
            buf, lim, v9_pos, mmeta, v9_lpos, v9_lmeta, lit),
        "resolve_matches": lambda: lg.resolve_matches(buf, v9_pos, mmeta),
        "resolve_matches_v2": lambda: lg.resolve_matches_v2(buf, v9_pos,
                                                            mmeta),
    }


@pytest.mark.parametrize("wrapper,entries", [
    ("resolve_groups_v11", ["dbg_groups_v11_lits", "dbg_groups_v11_chase"]),
    ("resolve_walk_v14", ["dbg_walk_v14_runs", "dbg_walk_v14_chase"]),
    ("resolve_groups_v9", ["dbg_groups_v9_chase"]),
    ("resolve_groups_v10", ["dbg_groups_v10_lits", "dbg_groups_v9_chase"]),
    ("resolve_matches", ["dbg_lz77_match"]),
    ("resolve_matches_v2", ["dbg_lz77_match"])])
def test_chase_wrappers_launch_the_chase_and_read_nothing_back(monkeypatch,
                                                              wrapper,
                                                              entries):
    """The card's branch of the archive resolvers on a grid-wide chase,
    taken here on CPU tensors with the launches recorded: exactly the
    literal entry (where the wrapper has one), then the chase entry (no
    in-order walk), each with as many arguments as its C entry takes; the
    group chase the last and first writer and a 64-bit state for every
    buffer byte, a list head for every row (128 bytes for the group rows
    10a, 10g and 10h, 512 for the match lists of rows 10c, 10e and 10f)
    and a link for every slot; and nothing read back to the host after
    the first launch."""
    from debigulator_tpu_torch.ops import _kernels
    from debigulator_tpu_torch.ops.archive import lz77_generations as lg

    calls = _chase_card_calls()[wrapper]
    made = []

    def refuse_after_launch(real):
        def guarded(*a, **k):
            if made:
                raise AssertionError("read back to the host between launches")
            return real(*a, **k)

        return guarded

    monkeypatch.setattr(lg, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch",
                        lambda entry, *a: made.append((entry, a)))
    for name in ("item", "tolist", "__bool__", "__int__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name,
                            refuse_after_launch(getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", refuse_after_launch(torch.nonzero))
    fn = getattr(lg, wrapper)
    before = fn.launches
    calls()
    monkeypatch.undo()
    assert [e for e, _ in made] == entries
    assert fn.launches == before + 1
    for entry, args in made:
        assert len(args) == len(_kernels._ENTRIES[entry][1])
    args = made[-1][1]
    last, first, state, heads, nxt = args[-5:]
    n_out = args[0].numel()
    assert args[1] == n_out
    assert last.dtype == first.dtype == heads.dtype == nxt.dtype \
        == torch.int32
    assert state.dtype == torch.int64
    assert last.numel() == first.numel() == state.numel() == n_out
    if wrapper == "resolve_walk_v14":
        piece, slots = 512, args[9] - args[8]
    elif wrapper.startswith("resolve_matches"):
        piece, slots = 512, args[4]
    else:
        piece, slots = 128, args[6]
    assert heads.numel() == -(-n_out // piece) + 2
    assert nxt.numel() == slots > 0


@pytest.mark.parametrize("entry", ["dbg_scan", "dbg_scan2", "dbg_pack_groups",
                                   "dbg_taint"])
def test_native_ctypes_declarations_match_the_source(entry):
    """The port's ctypes declarations of the native scanner entries against
    their prototypes in native/dbg_native.cpp."""
    import ctypes
    import re
    import types

    from debigulator_tpu_torch import native

    src = native._SRC.read_text()
    m = re.search(r"\nint64_t " + entry + r"\(([^)]*)\)", src)
    assert m, entry
    params = [" ".join(p.split())
              for p in re.sub(r"/\*.*?\*/", "", m.group(1)).split(",")]
    fns = {n: types.SimpleNamespace()
           for n in ("dbg_scan", "dbg_scan2", "dbg_pack_groups", "dbg_taint",
                     "dbg_crc32", "dbg_adler32")}
    native._declare(types.SimpleNamespace(**fns))
    fn = fns[entry]
    assert fn.restype is ctypes.c_int64
    assert len(fn.argtypes) == len(params)
    for decl, at in zip(params, fn.argtypes):
        if "*" in decl:
            assert at in (ctypes.c_void_p, ctypes.c_char_p) or (
                hasattr(at, "_type_") and at.__name__.startswith("LP_")), decl
            if at is not ctypes.c_void_p and at is not ctypes.c_char_p:
                want = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32,
                        "uint64_t": ctypes.c_uint64}[decl.split("*")[0].strip()]
                assert at._type_ is want, decl
        elif decl.startswith("uint64_t"):
            assert at is ctypes.c_uint64, decl
        else:
            assert decl.startswith("int64_t") and at is ctypes.c_int64, decl
