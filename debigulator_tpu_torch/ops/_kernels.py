"""Build, load and launch the port's CUDA kernels.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into a shared library with a plain C
interface, in the package's git-ignored build directory, at first use.
The libraries are loaded with ctypes.  Every C entry launches on the
stream it is given (PyTorch's current stream of the card its tensors lie
on, with that card current), allocates nothing, does not
synchronise, and returns ``cudaGetLastError()``; ``launch`` raises when it
is not 0.  Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import threading
import time

import torch

from debigulator_tpu_torch._build import build_libraries

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"phase_a": "phase_a.cu", "compact": "compact.cu", "walk": "walk.cu",
           "unfilter": "unfilter.cu", "greedy_walk": "greedy_walk.cu",
           "lz77_match": "lz77_match.cu", "lz77_tape": "lz77_tape.cu",
           "lz77_ops": "lz77_ops.cu", "groups_v11": "groups_v11.cu",
           "compact_v14": "compact_v14.cu",
           "walk_v14": "walk_v14.cu", "groups_v9": "groups_v9.cu",
           "microbench_pb": "microbench_pb.cu"}
#: Headers a source includes: hashed with it, so an edit rebuilds it.
HEADERS = {"walk": ["chase.cuh"], "microbench_pb": ["chase.cuh"],
           "lz77_match": ["chase.cuh", "group_chase.cuh"],
           **{name: ["lz77_copy.cuh", "chase.cuh"]
              for name in ("lz77_tape", "lz77_ops")},
           **{name: ["lz77_copy.cuh", "chase.cuh", "group_chase.cuh"]
              for name in ("groups_v11", "groups_v9", "walk_v14")}}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: C entry -> (library, argument types; the stream argument comes last).
_ENTRIES = {
    "dbg_phase_a_lut": ("phase_a", [_P, _I32, _P]),
    "dbg_phase_a": ("phase_a", [_P, _P, _P, _P, _I32, _I32, _P, _P, _P]),
    "dbg_phase_a_tape": ("phase_a", [_P, _P, _P, _P, _I32, _I32, _P, _P]),
    "dbg_compact": ("compact", [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                                _I32, _P, _P, _P, _P, _P]),
    "dbg_walk": ("walk", [_P, _I64, _I64, _P, _P, _I64, _P, _P, _I64, _P,
                          _I64]),
    "dbg_unfilter": ("unfilter", [_P, _P, _I32, _I32, _I32, _I32, _P]),
    "dbg_greedy_walk": ("greedy_walk", [_P, _P, _I64, _P, _P, _P, _P]),
    "dbg_lz77_match": ("lz77_match", [_P, _I64, _P, _P, _I64, _P, _P, _P,
                                      _P, _P]),
    "dbg_lz77_tape_place": ("lz77_tape", [_P, _I32, _P, _P, _P, _I32, _I32,
                                          _I32, _I32, _P, _P, _P]),
    "dbg_lz77_tape_chase": ("lz77_tape", [_P, _I32, _P, _P, _P, _I32, _I32,
                                          _P, _P]),
    "dbg_lz77_ops_place": ("lz77_ops", [_P, _I32, _P, _P, _P, _P, _P, _I64, _P,
                                        _P, _I32, _I32, _I32, _I32, _P, _P,
                                        _P]),
    "dbg_lz77_ops_chase": ("lz77_ops", [_P, _I32, _P, _P, _P, _I32, _I32, _P,
                                        _P]),
    "dbg_lz77_tape_v1_len": ("lz77_tape", [_P, _P, _I32, _I32, _P]),
    "dbg_groups_v11_lits": ("groups_v11", [_P, _I64, _P, _I32, _P, _P, _I64,
                                           _P, _I64]),
    "dbg_groups_v11_chase": ("groups_v11", [_P, _I64, _P, _I32, _P, _P, _I64,
                                            _P, _P, _P, _P, _P]),
    "dbg_compact_v14": ("compact_v14", [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _I32, _I32, _P, _P, _P, _P, _I64, _P,
                                        _I64]),
    "dbg_walk_v14_runs": ("walk_v14", [_P, _I32, _I32, _P, _P, _I32, _I32, _P,
                                       _I64]),
    "dbg_walk_v14_chase": ("walk_v14", [_P, _I64, _I32, _I32, _P, _I32, _P,
                                        _P, _I32, _I32, _P, _P, _P, _P, _P]),
    "dbg_groups_v10_lits": ("groups_v9", [_P, _I64, _P, _I32, _P, _P, _I64,
                                          _P, _I64]),
    "dbg_groups_v9_chase": ("groups_v9", [_P, _I64, _P, _I32, _P, _P, _I64,
                                          _P, _P, _P, _P, _P]),
    "dbg_microbench_pb": ("microbench_pb", [_P, _I64, _P, _P, _I32, _I32,
                                            _I32, _I32]),
    "dbg_microbench_chase": ("microbench_pb", [_P, _I64, _P, _P, _P, _I32,
                                               _I32, _P, _P, _P, _P, _P]),
}
#: C entries that take nothing and return a constant of the kernel's
#: layout -> library.
_CONSTANTS = {"dbg_greedy_chunk": "greedy_walk",
              "dbg_greedy_starts": "greedy_walk",
              "dbg_phase_a_lut_bits": "phase_a"}

_FNS: dict = {}
_VALUES: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> float:
    """Build (if needed) and load every kernel library; returns seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        if not _FNS:
            nvcc = _nvcc()
            specs = {name: ([CSRC / f for f in (src, *HEADERS.get(name, []))],
                            [nvcc, *NVCC_FLAGS, str(CSRC / src)])
                     for name, src in SOURCES.items()}
            libs = {name: ctypes.CDLL(str(path))
                    for name, path in build_libraries(specs).items()}
            for entry, (lib, argtypes) in _ENTRIES.items():
                fn = getattr(libs[lib], entry)
                fn.restype = ctypes.c_int
                fn.argtypes = [*argtypes, ctypes.c_void_p]
                _FNS[entry] = fn
            for entry, lib in _CONSTANTS.items():
                fn = getattr(libs[lib], entry)
                fn.restype, fn.argtypes = ctypes.c_int, []
                _VALUES[entry] = int(fn())
    return time.perf_counter() - t0


def launch(entry: str, *args) -> None:
    """Call a C entry with tensors passed as device pointers; raise on a
    launch error.  The tensors must lie on one card: the entry runs with
    that card current, on its current stream (the stream PyTorch's own
    work on those tensors is queued on), whichever card the caller has
    current."""
    conv, cards = [], set()
    for a in args:
        if isinstance(a, torch.Tensor):
            if not a.is_cuda or not a.is_contiguous():
                raise ValueError(f"{entry}: tensors must be contiguous CUDA tensors")
            cards.add(a.device)
            conv.append(a.data_ptr())
        else:
            conv.append(int(a))
    if len(cards) != 1:
        raise ValueError(f"{entry}: tensors must lie on one CUDA device, "
                         f"not {sorted(map(str, cards))}")
    (card,) = cards
    if not _FNS:
        build()
    with torch.cuda.device(card):
        err = _FNS[entry](*conv, torch.cuda.current_stream(card).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed (cudaError {err})")


def constant(entry: str) -> int:
    """A constant of a kernel's layout, as its library reports it."""
    if not _FNS:
        build()
    return _VALUES[entry]
