"""Native (C++) host runtime: the block/cell scanner, the record scan and
group packer of the host-fed decode, the taint analysis of the
split-stream decode, the serial inflate (the scanner with an output
buffer), CRC-32 and Adler-32.

Built with g++ from native/dbg_native.cpp (a source at the repo root) into
the port's own build directory; the JAX package's copy of the library is
never read or written.  ctypes declarations are the port's own copy of
those in debigulator_tpu/native/__init__.py.

``DBG_NO_NATIVE=1`` (read at call time, ``disabled()``) switches the
library off: the scanner then runs the Python scan of ops.scanner and the
host checksums their NumPy forms, and ``get_lib`` raises.  Only the
variable selects those: a library that cannot be built raises as well, so
nothing falls back quietly.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import threading

from debigulator_tpu_torch._build import build_libraries

_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "dbg_native.cpp"
_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC)]

_LIB = None
_LOCK = threading.Lock()


def disabled() -> bool:
    """True when DBG_NO_NATIVE asks for the pure-Python host paths."""
    return bool(os.environ.get("DBG_NO_NATIVE"))


def get_lib() -> ctypes.CDLL:
    """Load (building on first use) the native library.

    Thread-safe: concurrent first calls (the merged-plan scan pool) block
    on the lock instead of observing a half-initialized library.
    """
    global _LIB
    if disabled():
        raise RuntimeError("DBG_NO_NATIVE is set: the native library is off")
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            if not _SRC.exists():
                raise RuntimeError(f"native source missing: {_SRC}")
            path = build_libraries({"dbg_native": ([_SRC], _CMD)})["dbg_native"]
            _LIB = _declare(ctypes.CDLL(str(path)))
    return _LIB


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dbg_scan.restype = ctypes.c_int64
    lib.dbg_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dbg_scan2.restype = ctypes.c_int64
    lib.dbg_scan2.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dbg_pack_groups.restype = ctypes.c_int64
    lib.dbg_pack_groups.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.dbg_taint.restype = ctypes.c_int64
    lib.dbg_taint.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.dbg_crc32.restype = ctypes.c_uint32
    lib.dbg_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.dbg_adler32.restype = ctypes.c_uint32
    lib.dbg_adler32.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_uint32]
    return lib
