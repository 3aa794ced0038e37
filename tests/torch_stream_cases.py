"""Raw DEFLATE streams shared by the port's tests (tests/test_torch_*.py),
made with zlib from numpy seeds, and the helpers that carry a JAX-package
plan over to the port as numpy."""

import dataclasses
import fcntl
import os
import tempfile
import zlib

import numpy as np
import torch

from debigulator_tpu_torch.ops import plan as tp


def ensure_reference_native():
    """Load the JAX package's native library (the reference's scan and
    plan run on it) under a file lock shared by every test process.

    Each process that finds native/dbg_native.cpp newer than the
    package's .so rebuilds the .so in place, and a process that loads it
    while another writes it caches "no library" for good; the reference
    then plans without cell entries and its plans differ from the
    port's.  Under the lock one process builds or loads it at a time; a
    cached miss while the source exists and DBG_NO_NATIVE is unset is
    retried once, and the library must then load."""
    from debigulator_tpu import native as ref_native

    lock = os.path.join(tempfile.gettempdir(), "debigulator_tpu_native.lock")
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            lib = ref_native.get_lib()
            wanted = (ref_native._SRC.exists()
                      and not os.environ.get("DBG_NO_NATIVE"))
            if lib is None and wanted:
                ref_native._TRIED = False
                lib = ref_native.get_lib()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    assert lib is not None or not wanted, \
        "the JAX package's native library did not load"
    return lib


ensure_reference_native()


def deflate(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(data) + c.flush()


def words(n, seed=4, vocab=(b"merge ", b"batch ", b"op ", b"tape ", b"\n")):
    rng = np.random.default_rng(seed)
    return b"".join(vocab[int(v) % len(vocab)]
                    for v in rng.integers(0, len(vocab), n))


def nested_copies(n: int, seed: int = 11) -> bytes:
    """n bytes of 64-byte blocks, each a copy of the one before with one
    byte changed: a stream of copies of copies."""
    rng = np.random.default_rng(seed)
    cur = bytearray(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    out = bytearray()
    for r in rng.integers(0, 64 * 256, -(-n // 64)):
        out += cur
        cur[r % 64] = r // 64
    return bytes(out[:n])


def by_segment(call, init: np.ndarray, n_seg: int, seg_bytes: int,
               pad: int = 128, window: int = 32768) -> np.ndarray:
    """A segment resolver of the JAX package, one call a segment, over a
    buffer that holds n_seg bodies one after another: (pad row, window,
    n_seg * seg_bytes, slack rows), flat int32.  Segment i is resolved in
    a buffer of its own (the pad row, the 32 KiB before its body, its body,
    the slack rows) by call(buffer_2d, i), and every part is copied back,
    so segment i + 1's window holds what segment i wrote."""
    flat = init.reshape(-1).copy()
    body0 = pad + window
    slack = slice(body0 + n_seg * seg_bytes, None)
    for i in range(n_seg):
        win = slice(pad + i * seg_bytes, body0 + (i + 1) * seg_bytes)
        one = np.concatenate([flat[:pad], flat[win], flat[slack]])
        got = np.asarray(call(one.reshape(-1, 128), i)).reshape(-1)
        flat[:pad] = got[:pad]
        flat[win] = got[pad : pad + window + seg_bytes]
        flat[slack] = got[pad + window + seg_bytes :]
    return flat.reshape(init.shape)


def segments_init(data: np.ndarray, k0: int, n: int, seg_bytes: int,
                  odd: bool, pad: int = 128, w: int = 32768) -> np.ndarray:
    """A buffer for segments k0..k0+n-1 of `data`: pad row, the 32 KiB
    before segment k0 as the window, n zero bodies, 4 slack rows.  With
    `odd`, -1 in the pad row, the bodies and the slack rows, and values
    above 255 (every seventh -1) in the window instead of the data."""
    init = np.zeros(pad + w + n * seg_bytes + 512, np.int32)
    if odd:
        init[:] = -1
        init[pad : pad + w] = np.random.default_rng(7).integers(256, 1 << 20, w)
        init[pad : pad + w : 7] = -1
    else:
        off = k0 * seg_bytes
        tail = data[max(0, off - w) : off].astype(np.int32)
        init[pad + w - len(tail) : pad + w] = tail
    return init.reshape(-1, 128)


def _dynamic():
    return deflate(words(3000, seed=7))


def _fixed():
    # Low-entropy bytes keep zlib on fixed Huffman instead of stored blocks.
    rng = np.random.default_rng(2)
    return deflate(rng.integers(0, 16, 12_000, dtype=np.uint8).tobytes(),
                   strategy=zlib.Z_FIXED)


def _stored():
    rng = np.random.default_rng(1)
    return deflate(rng.integers(0, 256, 9000, dtype=np.uint8).tobytes(), 0)


def _mixed():
    """Dynamic, stored and dynamic blocks; the last block's matches reach
    back into the stored bytes."""
    rng = np.random.default_rng(13)
    mid = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    st = c.compress(b"prefix text " * 400) + c.flush(zlib.Z_SYNC_FLUSH)
    st += c.compress(mid) + c.flush(zlib.Z_SYNC_FLUSH)
    return st + c.compress(mid[1000:3000] + b"suffix text " * 400) + c.flush()


def _rle():
    """dist 1 runs, a period-3 pattern and matches of the full length 258."""
    return deflate(b"a" * 5000 + b"bcd" * 700 + b"\x00" * 9000)


def fixed_block(tokens) -> bytes:
    """One final fixed-Huffman block from (lit, len, dist) tokens (lit -1
    marks a match), packed with the port's host encoder helpers: streams
    zlib itself never writes, such as a match at distance 32768."""
    from debigulator_tpu_torch.ops import deflate_encode as enc

    vals, bits = enc._tokens_to_fields(
        tokens, enc._FIXED_LITLEN_CODES, enc._FIXED_LITLEN_LENGTHS,
        enc._FIXED_DIST_CODES, enc._FIXED_DIST_LENGTHS)
    eob_bits = int(enc._FIXED_LITLEN_LENGTHS[256])
    eob_val = int(enc._reverse_bits(
        np.array([enc._FIXED_LITLEN_CODES[256]]), np.array([eob_bits]))[0])
    vals = np.concatenate([vals, [np.uint64(eob_val)]])
    bits = np.concatenate([bits, [eob_bits]])
    return enc.pack_bits(vals, bits, prefix_bits=3, prefix_val=0b011)[0]


def _far():
    """Matches at distance 32768, the window's edge (zlib stops 262 short
    of it), of length 258 and 3, then a dist 1 run of 258."""
    rng = np.random.default_rng(3)
    toks = [(int(v), 0, 0) for v in rng.integers(0, 256, 32768)]
    toks += [(-1, 258, 32768), (-1, 3, 32768), (65, 0, 0), (-1, 258, 1),
             (-1, 100, 32768 - 7), (66, 0, 0)]
    return fixed_block(toks)


def _flushed():
    """Many blocks: a full flush every 700 bytes of text."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = words(6000, seed=11)
    out = b""
    for i in range(0, len(data), 700):
        out += c.compress(data[i : i + 700]) + c.flush(zlib.Z_FULL_FLUSH)
    return out + c.flush()


def _dense():
    """Four symbols, Huffman only: 2-bit codes, 32 tokens in a 64-bit cell,
    so 16 tape slots overflow."""
    rng = np.random.default_rng(5)
    return deflate(rng.integers(0, 4, 6000, dtype=np.uint8).tobytes(),
                   strategy=zlib.Z_HUFFMAN_ONLY)


STREAMS = {"dynamic": _dynamic, "fixed": _fixed, "stored": _stored,
           "mixed": _mixed, "rle": _rle, "far": _far, "flushed": _flushed,
           "dense": _dense}


def to_port_plan(ref_plan) -> tp.PlanV3:
    """A JAX-package PlanV3 as the port's PlanV3."""
    return tp.plan_from_numpy(dataclasses.asdict(ref_plan))


def to_port_arrays(ref_arrays: dict) -> dict:
    """The twin of the reference's plan_arrays_v3 dict: every jax array as
    a CPU tensor (``tile_page`` has no counterpart and is dropped;
    ``first_state`` becomes an int)."""
    out = {}
    for k, v in ref_arrays.items():
        if k == "tile_page":
            continue
        if k == "first_state":
            out[k] = int(v)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out
