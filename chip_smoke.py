#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (debigulator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --parallel-only

Builds the host library and the eighteen CUDA kernels from this checkout
and holds every kernel bit-exact against its plain PyTorch version on the
card.
Each phase prints one JSON line:

* card, build;
* kernels_vs_plain: Phase A, compact and the walk at ~1.1 MB of output;
* phase_a_vs_plain: both Phase A kernels at every slots value 8-128 (16
  on the main path's plan; all on a two-stream plan and on a zero run
  merged with text, whose cells hold up to 32 tokens) and the first-level
  decode table kernel on the plans' tables and on synthetic code sets
  (incomplete, over-subscribed, one 1-bit code, all codes of 15 bits, no
  distance codes, rows that follow no canonical code), each bit-exact
  against its plain version, with the share of table entries left to the
  canonical probe; both kernels' ms, device ms (replayed from a CUDA
  graph) and bound at every slots value on the main path's plan;
* main_path: 29 distinct raw DEFLATE streams of about 562 KB each (the
  shape of bench.py's workload, synthetic OBJ-like text made from a fixed
  seed) through build_merged_plan -> prepare_merged -> run on "cuda", every
  stream checked against zlib; profile (device busy share and top kernels);
* walk_vs_plain: the LZ77 walk (a grid-wide source chase) against its
  plain version on a 4 MiB zero run at level 9 (dist-1 chains ~16,000
  deep), 2 MiB of copies of copies, the two with a main-path stream as a
  merged batch, and every walk of a chunked long-stream decode that has a
  window prologue; chain-depth histograms, kernel and plain ms, bounds;
* unfilter_vs_plain, greedy_walk_vs_plain: the PNG unfilter at a small
  size with every filter type, on batches, on 1024x1024 and 4096x4096 RGBA,
  and on images taller than one CTA's shared memory could hold (20,000 x 1
  RGBA8 and 9,400 x 2 16-bit RGBA against the NumPy oracle, a 20,000 x 256
  RGBA8 PNG through decode_png_device against its pixels); the encoder's
  greedy walk at edge shapes, on a 4 MB filtered image, and at that size on
  every len 3 (no_merge), every len 11 and 258-long matches across every
  chunk boundary, each with the chunks' fix-up lengths;
* png_path: a corpus of 16 PNGs made from numpy seed 0 with zlib and
  struct (about 64 MB of RGBA: RGBA, RGB, gray+alpha, palette with tRNS,
  gray, and one image cycling through all five filters) through
  decode_png_corpus_device, decode_png_device and decode_png_batch, every
  image equal to its source pixels, then one 4096x4096 RGBA image through
  decode_png_device; the walk's work, bound and device ms inside the
  corpus call and inside the large image's call, Phase A's slots and
  device ms (replayed) on the corpus call's plan, and the large image's
  call taken apart (host steps, top device operations);
* encode_path: deflate_fixed_device on the filtered rows of a 1024x1024
  RGBA image (checked with zlib), then encode_png on the card and
  decode_png_device of the result equal to the image;
* compact_edge_cases: the compact kernel against its plain version on
  inputs that stress its look-back (every chunk empty, a fill carried from
  599 chunks back, every record valid, one chunk);
* kernel_times (the library yardstick of compact is masked_select of each
  of the four arrays it compacts; Phase A's device time by kernel, the
  table build and the decode, and a call's device time without its host
  launch cost, replayed from a CUDA graph), entry_points (two-member gzip, the
  chunked long-stream decode, a stored/dynamic mix);
* phase_a_tape_vs_plain, lz77_tape_vs_plain, lz77_ops_vs_plain,
  lz77_match_vs_plain: the token-tape Phase A and the three LZ77 resolvers
  of the other decode drivers, at two streams, on a segment cut from the
  middle of a body (window tail, head and tail clip) and at the main path's
  29 streams (row 6's and the two segment resolvers' device time by
  operation; row 6's call also replayed from a CUDA graph); the segment
  resolvers also on the walk's shapes (zero run, copies of copies, both
  merged with a text stream; chain-depth histograms, ms, plain ms) and on
  a buffer and tapes padded with -1; the match-list resolver (the group
  chase with groups of one) on one stream, on a hand-made list and on
  lists that rewrite bytes (REWRITE_LISTS: a reader between two writers, a
  write after a read, three writers of a byte, distance 0 and length 0, a
  258-long overlapping run, n_matches short of the list), each also
  against a serial walk in numpy; its ms replayed from a CUDA graph and
  its scratch bytes;
* fallback_paths: the same 29 streams through the speculative drivers
  (Python scans, no cell entries: the merged plan through prepare_merged ->
  v5, one stream through inflate_device under DBG_NO_NATIVE=1 -> v4), the
  v13 driver (DBG_PHASE_B=v13), the v7 driver and one stream through the
  all-tensor-op v3, every stream checked against zlib; sweeps of the entry
  fixpoint, graph / chase / resolve ms, peak memory; v7's and v13's device
  ms and their Phase B (glue and resolver) ms;
* groups_v11_vs_plain, compact_v14_vs_plain, walk_v14_vs_plain,
  tape_v1_vs_plain: the archived generations' kernels at two streams, on
  one 512 KiB segment of the host-fed packing and an 8 KiB segment of the
  v14 walk (window tail, head and tail clip), and at the 29 streams (the
  v1 resolver on one stream); the v14 compaction also on cells empty, full
  and overflowed (library yardstick: masked_select of its five arrays);
  the group resolver also on hand-made lists that break the packer's
  rules (group_case: pieces reading their own group's and later groups'
  writes, bytes written twice in a group, 4,096 pieces over one row); the
  v14 walk also on dense lists that write bytes twice in and out of
  groups marked clean and on a clean group split by two segments
  (v14_rewrite_case), and at two streams, each against a serial walk in
  numpy; at 29 streams its launches replayed from a CUDA graph;
* archive_paths: the 29 streams through the host-fed v10 decode (record
  scan, group packer and piece words by tools/profile_merged's
  host_fed_inputs, then inflate_v10) and the v14 driver, one stream through tape_v3 and the v1
  resolver, every stream checked against zlib; host ms and device ms;
* match_v1_vs_plain, match_v2_vs_plain, groups_v9_vs_plain,
  groups_v10_vs_plain, microbench_pb_vs_plain: the archived kernels no
  path of the JAX package calls, on a hand-made match list (overlaps, a
  window tail, padding rows), the lists that rewrite bytes and one
  stream's tape, each against a serial walk in numpy too, one stream's
  list also replayed from a CUDA graph; on one 512 KiB segment
  cut from the middle of a body, at the 29 streams (replayed from a CUDA
  graph too), on the walk's zero run, copies of copies and merged batch,
  and on group_case's hand-made lists, with the group chase's scratch
  bytes; the piece loop's variants at 2^16 pieces and its full loop at
  2^21, both on random bytes;
* microbench_pb: the tool's own run (python3 -m
  debigulator_tpu_torch.tools.microbench_pb), every variant at 2^21
  pieces, ns per piece;
* archive_paths_2: one stream's token tape through the v2 and v1
  match-list resolvers, the 29 streams through the record scan,
  build_group_arrays_v10 and the v9 and v10 group kernels, every stream
  checked against zlib; host ms and device ms;
* parallel_paths: the split-stream decode of one stream over four shards
  (the 29 rotations as one 16,294,288-byte stream at level 6, and a 4 MiB
  b"ab" run whose taint reaches every shard's tail: three rounds), each
  once through decode_split_stream on a 4-entry sp mesh of the card (what
  decode_split_emulated runs); decode_batch_device on the 29 streams (one
  device, and a mesh of the card) and decode_png_batch(mesh=make_mesh())
  on the PNG corpus; every output exact.  Per stream: rounds, tainted
  matches and their share, host plan and staging ms, phase 1 and each
  round by CUDA events, e2e ms and walk launches; the walk against its
  plain version on shard 1's phase-1 list and first patch round;
* front_door: the host encoder on the card's host (deflate and
  encode_gzip of the OBJ text, ms and bytes; encode_png with its default,
  the host encoder, on a 512 x 512 crop of the encode path's image beside
  the device encoder on the same rows), then the CLIs as subprocesses:
  cuda_gz decode --repeat 3 --trace of the text gzipped by encode_gzip and
  by gzip (first and steady ms, the top-ops list, which names the
  flagship's scopes, and the trace's kernels as the CLI lists them, which
  must hold Phase A, compact and the walk), cuda_gz encode, cuda_png
  decode --bench of the 16-image corpus, encode and roundtrip of a 192 x
  192 crop, cuda_bmp roundtrip and info; every output checked against
  zlib or the pixels;
* multihost: parallel/multihost.py's world of two processes on the card
  over the 29 streams (gloo carries the manifest) beside a world of one:
  every stream exact in its worker, the manifest equal to zlib's sizes
  and CRC-32s, rows 1-3 launched in every worker, each worker's ms;
* tools: the five profiling tools of debigulator_tpu_torch/tools, each
  function called here on the card at its defaults (trace_v15 on the 29
  streams with its trace, profile_r3 on 16 copies of the first stream,
  profile_encoder and profile_corpus on this script's corpus,
  check_4k_unfilter on tools/inputs.k4_png's 4096x4096 RGBA image, whose
  scanlines' sha256 is checked first), each with its wall seconds and the
  launches of rows 1-5 and 9 it made (after the kernels line's counts were
  read), and trace_v15 --no-trace once as a subprocess (its -m entry);
* kernels: per kernel its launches on its path, times and bound (the
  rows on the group chase also their replayed ms and scratch bytes; the
  walk and the unfilter also their launches on parallel_paths, the walk
  its split shapes).

With --parallel-only the script builds, then runs parallel_paths with its
meshes over every card the machine has (the sp mesh takes the cards in
turn, the dp meshes one row a card) and multihost with one rank a card
(at least two), and prints no kernels line: the check of the mesh layer
and of multi-process decode across cards.

The line before the last is the card's name and power limit as nvidia-smi
reports them, and the last line is {"ok": true, "device": {...}}.  Any
mismatch, build failure or launch error raises and the script exits
non-zero without that line.
"""

from __future__ import annotations

import gzip
import json
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from debigulator_tpu_torch.tools.inputs import (
    BIG_SIDE,
    N_STREAMS,
    big_image_png,
    make_corpus,
    make_png,
    make_streams,
    obj_text,
    smooth_pixels,
)

#: H100 SXM published peaks (NVIDIA data sheet, as listed in the repo's
#: measurement notes): HBM bandwidth, and the non-tensor 32-bit rate that
#: the integer work of these kernels is counted against.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
#: Rough integer operations per decoded Huffman symbol in Phase A (15-length
#: probe with telescoped offset, table lookup, window and state update).
OPS_PER_SYMBOL = 120

#: The hand-made shapes of group_case.
GROUP_SHAPES = ("clashing", "two_writer", "many_writer")


def group_scratch_bytes(n_out: int, n_slots: int, piece: int = 128) -> int:
    """The group chase's scratch (ops.lz77.group_chase_state): the last and
    first writer (int32) and a 64-bit state per buffer byte, a list head
    per `piece`-byte row and a link per slot."""
    return 16 * n_out + 4 * (-(-n_out // piece) + 2 + n_slots)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call from CUDA events over `reps` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def replay_ms(fn, reps: int = 20) -> float:
    """Device ms of one call of `fn` without its host launch cost: the call
    captured once in a CUDA graph, CUDA events around `reps` replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def host_ms(fn, reps: int = 3) -> float:
    """Median wall ms of `reps` calls of a host-side step."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired tensors; raises on a shape change."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    return err


def gpu_filtered(filtered: bytes, dev) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(filtered, np.uint8).copy()).to(dev)


def check_unfilter(name, filt: torch.Tensor, h, w, bpp, uf, reps=3):
    """One shape of the unfilter kernel against its plain version; returns
    the JSON record with the times and the byte bound."""
    got = uf.unfilter(filt, h, w, bpp)
    torch.cuda.synchronize()
    want = uf.unfilter_plain(filt, h, w, bpp)
    err = max_abs_err((got,), (want,))
    if err:
        raise AssertionError(f"unfilter disagrees with its plain version at {name}")
    t0 = time.perf_counter()
    uf.unfilter_plain(filt, h, w, bpp)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    return {"shape": name, "batch": filt.shape[0] if filt.dim() == 2 else 1,
            "h": h, "w": w, "bpp": bpp, "max_abs_err": err,
            "ms": time_ms(lambda: uf.unfilter(filt, h, w, bpp), reps),
            "plain_ms": plain_ms,
            "bound_ms": (filt.numel() + got.numel()) / HBM_BYTES_PER_S * 1e3}


#: Tall images of the banded unfilter: (name, h, w, bpp, filter types);
#: None draws a random filter type per row.
TALL_SHAPES = (("rgba8_20000x1", 20_000, 1, 4, 0),
               ("rgba16_9400x2", 9_400, 2, 8, None))
#: (h, w) of the tall RGBA8 PNG decoded through decode_png_device.
TALL_PNG = (20_000, 256)


def tall_unfilter_checks(dev, uf, pl) -> list:
    """Images taller than one CTA's shared memory could hold: the unfilter
    kernel on 20,000 x 1 RGBA8 (filter 0, random bytes) and 9,400 x 2
    16-bit RGBA (bpp 8, random filter types), each equal to the NumPy
    oracle; a 20,000 x 256 RGBA8 PNG through decode_png_device equal to
    its source pixels."""
    rng = np.random.default_rng(6)
    out = []
    for name, h, w, bpp, ftype in TALL_SHAPES:
        raw = rng.integers(0, 256, (h, 1 + w * bpp), dtype=np.uint8)
        raw[:, 0] = rng.integers(0, 5, h) if ftype is None else ftype
        filt = torch.from_numpy(raw.reshape(-1)).to(dev)
        got = uf.unfilter(filt, h, w, bpp)
        torch.cuda.synchronize()
        if not np.array_equal(got.cpu().numpy(),
                              uf.unfilter_image(raw.reshape(-1), h, w, bpp)):
            raise AssertionError(f"tall image {name} is not exact")
        out.append({"shape": name, "h": h, "w": w, "bpp": bpp, "exact": True,
                    "ms": time_ms(lambda: uf.unfilter(filt, h, w, bpp), 3),
                    "bound_ms": (filt.numel() + got.numel())
                    / HBM_BYTES_PER_S * 1e3})
    h, w = TALL_PNG
    pix = smooth_pixels(rng, h, w, 4)
    png, filtered = make_png(pix, 6, 6)
    pl.decode_png_device(png, device=dev)  # warm-up; the second call is timed
    t0 = time.perf_counter()
    got = pl.decode_png_device(png, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(got, pix):
        raise AssertionError("the tall PNG differs from its source")
    filt = gpu_filtered(filtered, dev)
    out.append({"shape": f"png_rgba8_{h}x{w}", "h": h, "w": w, "bpp": 4,
                "exact": True, "decode_png_device_ms": ms,
                "rgba_bytes": pix.nbytes,
                "ms": time_ms(lambda: uf.unfilter(filt, h, w, 4), 3),
                "bound_ms": 2 * pix.nbytes / HBM_BYTES_PER_S * 1e3})
    return out


def compact_case(rng, dev, slots: int, counts: np.ndarray, dst_hi):
    """phase_b.Records of cells with the given match counts (and run counts
    rolled by one cell): valid slots hold random dst below dst_hi[cell]
    and a non-zero meta, the rest zeros; chunk bases as prep_records
    lays them out."""
    from debigulator_tpu_torch.ops import phase_b as pb

    n_chunks = len(counts) // pb.CHUNK_CELLS
    lists = []
    for cnt in (counts, np.roll(counts, 1)):
        valid = (np.arange(slots)[None, :] < cnt[:, None]).reshape(-1)
        hi = np.repeat(np.asarray(dst_hi, np.int64), slots)
        d = np.where(valid, rng.integers(0, 1 << 62, valid.size) % hi, 0)
        m = np.where(valid, rng.integers(1, 1 << 31, valid.size), 0)
        rows = -(-cnt.reshape(n_chunks, -1).sum(1) // 128)
        lists += [torch.from_numpy(d.astype(np.int32)).to(dev),
                  torch.from_numpy(m.astype(np.int32)).to(dev),
                  torch.from_numpy((np.cumsum(rows) - rows).astype(np.int32)).to(dev)]
    dm, mm, mbase, dr, mr, rbase = lists
    return pb.Records(dm, mm, dr, mr, mbase, rbase, None)


def compact_edge_cases(dev) -> list:
    """Row 2 against its plain twin on inputs that stress the look-back:
    every chunk empty; a fill carried from the first chunk through 599
    chunks of smaller dst (most of them empty); every record valid; a
    single chunk."""
    from debigulator_tpu_torch.ops import phase_b as pb

    rng = np.random.default_rng(7)
    cells = pb.CHUNK_CELLS
    far = np.zeros(600 * cells, np.int64)
    far[:cells] = rng.integers(0, 9, cells)
    far[cells * 50 :: cells * 50] = 3
    far_hi = np.full(600 * cells, 1000)
    far_hi[:cells] = 1 << 29
    cases = {
        "all_empty": (8, np.zeros(4 * cells, np.int64), np.ones(4 * cells)),
        "far_fill": (8, far, far_hi),
        "all_valid": (16, np.full(8 * cells, 16), np.full(8 * cells, 1 << 30)),
        "single_chunk": (32, rng.integers(0, 33, cells), np.full(cells, 1 << 30)),
    }
    out = []
    for name, (slots, counts, hi) in cases.items():
        rec = compact_case(rng, dev, slots, counts, hi)
        got = pb.compact(rec, slots)
        torch.cuda.synchronize()
        out.append({"case": name, "slots": slots,
                    "chunks": len(counts) // cells,
                    "max_abs_err": same(f"compact {name}", got,
                                        pb.compact_plain(rec, slots))})
    return out


def compact_v14_edge_case(dev) -> dict:
    """Row 10b against its plain twin on 2,048 cells of 16 slots where a
    third of the cells are empty, a third full and a few overflowed (a
    count past `slots`, read as `slots`, its offset span a gap of
    zeros)."""
    from debigulator_tpu_torch.ops.archive import lz77_generations as lg

    rng = np.random.default_rng(8)
    cells, slots = 2048, 16
    kind = rng.integers(0, 3, (3, cells))
    counts = np.where(kind == 0, 0, np.where(kind == 1, slots,
                                             rng.integers(1, slots, (3, cells))))
    counts[:, 5::97] = 40
    cnt = (counts[0] << 16) | (counts[1] << 8) | counts[2]
    nrows = cells * slots // 128 + 2 * lg.V14_STAGE_ROWS + 2
    nrows_lit = cells * slots // 128 + 2
    if counts[:2].sum(1).max() > nrows * 128 or counts[2].sum() > nrows_lit * 128:
        raise AssertionError("edge case does not fit its outputs")

    def rows(a):
        return torch.from_numpy(np.asarray(a, np.int32)).view(-1, 128).to(dev)

    args = ([rows(rng.integers(1, 1 << 31, cells * slots)) for _ in range(5)]
            + [rows(cnt)] + [rows(np.cumsum(c) - c) for c in counts]
            + [nrows, nrows_lit, slots])
    got = lg.compact_v14(*args)
    torch.cuda.synchronize()
    return {"case": "empty_full_overflow", "cells": cells, "slots": slots,
            "max_abs_err": same("compact_v14 edge case", got,
                                lg.compact_v14_plain(*args))}


def same(name, got, want) -> int:
    """max_abs_err of paired tensors; raises unless it is 0."""
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def spy(module, name, store):
    """Keep the arguments of every call of the module's `name`, in order,
    as store[name]; returns the real function, which the caller puts
    back."""
    real = getattr(module, name)

    def wrapper(*a, **k):
        store.setdefault(name, []).append((a, k))
        return real(*a, **k)

    wrapper.launches = 0
    setattr(module, name, wrapper)
    return real


def walk_work_of(resolves: list) -> dict:
    """walk_work summed over phase_b.resolve calls kept by spy."""
    total: dict = {}
    for a, _ in resolves:
        ma, mb, ra, rb, lit, cnt, outlen = a[:7]
        work = walk_work(cnt, mb, a[11], int(outlen.long().sum())
                         + a[10].numel())
        for k, v in work.items():
            total[k] = total.get(k, 0) + v
    total["walks"] = len(resolves)
    return total


def window_buffer(flat, off: int, body, dev):
    """A resolver buffer of one segment: pad row, the 32 KiB of `flat`
    (numpy bytes) before `off`, `body` (int32), four slack rows."""
    from debigulator_tpu_torch.ops import lz77 as lz

    init = torch.zeros(lz.BODY_START + body.numel() + lz.SLACK_ROWS * 128,
                       dtype=torch.int32)
    tail = flat[max(0, off - lz.WINDOW) : off].astype(np.int32)
    init[lz.BODY_START - len(tail) : lz.BODY_START] = torch.from_numpy(tail)
    init[lz.BODY_START : lz.BODY_START + body.numel()] = body.cpu()
    return init.view(-1, 128).to(dev)


def require_launches(path: str, launches: dict, names) -> None:
    """Fail unless every named kernel was launched on this path's run."""
    missing = [k for k in names if launches[k] <= 0]
    if missing:
        raise AssertionError(
            f"{path}: kernels never launched: {missing} (counts {launches})")


def stages(st, slots):
    """The flagship body's stages on a staged plan, kernels and plain
    versions on the same inputs.  Returns a dict of inputs and outputs."""
    from debigulator_tpu_torch.ops import phase_a as pa
    from debigulator_tpu_torch.ops import phase_b as pb

    a_k = pa.phase_a(st.pa, slots)
    a_p = pa.phase_a_plain(st.pa.cellw, st.pa.cell_block, st.pa.tables, slots)
    rec = pb.prep_records(*a_k, st.pa.bob_cell, slots)
    c_k = pb.compact(rec, slots)
    c_p = pb.compact_plain(rec, slots)
    mdst, mmeta, rdst, rmeta = c_k
    init = pb.init_body(st.n_seg, st.stored_pos, st.stored_val,
                        device=mdst.device)
    w_k = pb.walk(init.clone(), mdst, mmeta, rdst, rmeta, rec.lit)
    w_p = pb.walk_plain(init.clone(), mdst, mmeta, rdst, rmeta, rec.lit)
    torch.cuda.synchronize()
    return {"a_k": a_k, "a_p": a_p, "rec": rec, "c_k": c_k, "c_p": c_p,
            "init": init, "w_k": w_k, "w_p": w_p}


def phase_a_phase(dev, st_path, small_plan) -> dict:
    """Rows 1 and 6 against their plain versions at every slots value the
    wrappers take: 16 on the main path's plan; all of them on a two-stream
    plan, where 8 overflows, and on a 4 MiB zero run merged with 300 KB of
    text, whose dense cells hold more tokens than the 16 slots the kernels
    stage.  Both timed at every slots value on the main path's plan
    (tools/phase_a_slots.sweep), and the table kernel against
    decode_lut_plain on the plans' tables and on synthetic code sets."""
    from debigulator_tpu_torch.ops import _kernels
    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.ops import phase_a as pa
    from debigulator_tpu_torch.parallel.merged import build_merged_plan
    from debigulator_tpu_torch.tools.phase_a_slots import SLOTS, sweep

    sys.path.append(str(Path(__file__).resolve().parent / "tests"))
    from torch_lut_cases import synthetic_lut_tables

    lut_bits = _kernels.constant("dbg_phase_a_lut_bits")
    if lut_bits != pa.LUT_BITS:
        raise AssertionError(f"the table kernel has {lut_bits} bits, "
                             f"ops.phase_a.LUT_BITS {pa.LUT_BITS}")
    dense = []
    for data, level in ((bytes(4 << 20), 9), (obj_text(size=300_000), 6)):
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        dense.append(c.compress(data) + c.flush())
    staged = {"gzip_29": st_path, "gzip_2": inf.stage_plan(small_plan, dev),
              "dense": inf.stage_plan(build_merged_plan(dense).plan, dev)}
    rows = []
    for label, st in staged.items():
        x = st.pa
        for slots in (16,) if label == "gzip_29" else SLOTS:
            err1 = same("phase_a", pa.phase_a(x, slots), pa.phase_a_plain(
                x.cellw, x.cell_block, x.tables, slots))
            tape, counts = pa.phase_a_tape(x, slots)
            err6 = same("phase_a_tape", (tape, counts), pa.phase_a_tape_plain(
                x.cellw, x.cell_block, x.tables, slots))
            rows.append({"plan": label, "slots": slots,
                         "cells_pad": int(x.cellw.shape[1]),
                         "max_abs_err": {"phase_a": err1, "phase_a_tape": err6},
                         "max_cell_tokens": int(counts.max()),
                         "cells_over_16": int((counts > 16).sum()),
                         "overflowed_cells": int((counts > slots).sum())})
            del tape, counts
    torch.cuda.empty_cache()
    timed = sweep(st_path.pa)
    tables = {label: st.pa.tables for label, st in staged.items()}
    tables.update({k: torch.from_numpy(v).to(dev)
                   for k, v in synthetic_lut_tables().items()})
    luts = {}
    for name, tab in tables.items():
        got = pa.decode_lut(tab)
        want = pa.decode_lut_plain(tab)
        luts[name] = {"blocks": int(tab.shape[0]),
                      "max_abs_err": same("decode_lut", (got,), (want,)),
                      "non_final_share": float(
                          ((got & pa.LUT_FINAL) == 0).double().mean())}
    torch.cuda.synchronize()
    return {"phase": "phase_a_vs_plain", "bit_exact": True,
            "lut_bits": lut_bits, "slots": rows, "timed_gzip_29": timed,
            "decode_lut": luts}


#: The walk's three kernels (csrc/walk.cu) as torch.profiler names them.
WALK_KERNEL_NAMES = ("::run_kernel(", "::pointer_kernel(", "::chase_kernel(")


def device_parts(fn, reps: int = 3) -> list:
    """Device ms a call of each operation `fn` runs, by torch.profiler over
    `reps` calls after one warm-up: [[name, ms, launches a call], ...],
    longest first.  Launches below the call's own show that the profiler
    lost records."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return [[e.key[:60], e.self_device_time_total / 1e3 / reps,
             e.count / reps]
            for e in sorted(events, key=lambda e: -e.self_device_time_total)]


def walk_device_ms(events) -> float:
    """Device ms of the walk's kernels among profiler key averages."""
    return sum(e.self_device_time_total for e in events
               if any(k in e.key for k in WALK_KERNEL_NAMES)) / 1e3


def walk_work(cnt, mb, slots: int, out_size: int) -> dict:
    """What one walk must move to and from HBM, from Phase A's counts and
    match metas: the run records (2 words), the literals, the match
    records (dst and meta), and each output element written once.  A
    match's source lies within 32 KiB before it, so it can be held on
    chip and is not charged; match_bytes (the bytes the matches copy) is
    reported beside.  Bytes at 4 per int32 element."""
    cnt = cnt.long()
    mc = (cnt >> 16) & 0xFF
    valid = torch.arange(slots, device=mb.device)[:, None] < mc[None, :]
    work = {"matches": int(mc.sum()), "runs": int(((cnt >> 8) & 0xFF).sum()),
            "literals": int((cnt & 0xFF).sum()),
            "match_bytes": int(((mb.long() >> 16) * valid).sum()),
            "out_bytes": out_size}
    work["bytes"] = 4 * (2 * work["runs"] + work["literals"]
                         + 2 * work["matches"] + out_size)
    return work


def chain_depths(out_len: int, mdst, mmeta) -> dict:
    """Histogram of the walk's chain depths: for every element of the
    buffer, the copies its value passes through (0: literal, stored or
    window byte), by the kernel's rule s = d - dist + i % dist, counted by
    pointer doubling.  Buckets 0, 1, 2-3, 4-7, ...; also max and mean."""
    from debigulator_tpu_torch.ops import phase_b as pb

    dev = mdst.device
    mlen = (mmeta >> 16).long()
    dist = (mmeta & 0xFFFF).long()
    live = (mdst < pb.BIG) & (mlen > 0) & (dist > 0)
    d = mdst[live].long() + pb.WINDOW
    dist = dist[live]
    rec, off = pb._expand(mlen[live])
    pos = d[rec] + off
    src = d[rec] - dist[rec] + off % dist[rec]
    keep = (pos < out_len) & (src >= 0)
    ptr = torch.arange(out_len, device=dev)
    ptr[pos[keep]] = src[keep]
    depth = (ptr != torch.arange(out_len, device=dev)).int()
    del rec, off, pos, src, keep
    while True:
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            break
        depth = depth + depth[ptr]
        ptr = nxt
    depth = depth[pb.WINDOW :]
    bucket = torch.where(depth > 0,
                         1 + torch.log2(depth.clamp(min=1).double()).floor().long(),
                         0)
    counts = torch.bincount(bucket).tolist()
    labels = ["0"] + [f"{1 << (b - 1)}-{(1 << b) - 1}" if b > 1 else "1"
                      for b in range(1, len(counts))]
    return {"max": int(depth.max()), "mean": float(depth.double().mean()),
            "buckets": dict(zip(labels, counts))}


def greedy_fixups(best_len, chunk: int, starts: int) -> dict:
    """How far each chunk of the greedy-walk kernel re-walks in its
    hand-off: from its true entry to the first position where the true
    parse meets one of the chunk's speculative parses (from its first
    `starts` positions; the chunk's end if never), by pointer doubling in
    plain PyTorch.  Summary over the chunks."""
    n = best_len.numel()
    dev = best_len.device
    ln = best_len.long()
    idx = torch.arange(n, device=dev)
    nxt = torch.clamp(idx + torch.where(ln >= 3, ln, 1), max=n)
    end = torch.clamp((idx // chunk + 1) * chunk, max=n)

    def orbit(starts, jump):
        vis = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        vis[starts] = True
        jump = torch.cat([jump, torch.full((1,), n, device=dev)])
        for _ in range(max(1, n.bit_length())):
            vis[jump[vis.nonzero()[:, 0]]] = True
            jump = jump[jump]
        return vis[:n]

    true = orbit(torch.zeros(1, dtype=torch.long, device=dev), nxt)
    first = torch.arange(0, n, chunk, device=dev)
    first = (first[:, None] + torch.arange(starts, device=dev)).reshape(-1)
    spec = orbit(first[(first < n) & (first % chunk < starts)],
                 torch.where(nxt < end, nxt, n))
    n_chunks = -(-n // chunk)
    cid = idx // chunk
    big = torch.full((n_chunks,), n, dtype=torch.long, device=dev)
    entry = big.scatter_reduce(0, cid[true], idx[true], "amin")
    both = true & spec
    merge = big.scatter_reduce(0, cid[both], idx[both], "amin")
    chunk_end = torch.clamp((torch.arange(n_chunks, device=dev) + 1) * chunk,
                            max=n)
    has = entry < n
    never = has & (merge >= chunk_end)
    fix = torch.where(has, torch.minimum(merge, chunk_end) - entry, 0)
    q = torch.quantile(fix[has].double(), torch.tensor(
        [0.5, 0.9, 0.99], dtype=torch.float64, device=dev)).tolist() \
        if bool(has.any()) else [0.0, 0.0, 0.0]
    return {"chunks": n_chunks, "with_entry": int(has.sum()),
            "merged_at_entry": int((has & (fix == 0)).sum()),
            "never_merged": int(never.sum()),
            "rewalked": int(fix.sum()), "max": int(fix.max()),
            "p50_p90_p99": q}


def walk_case_streams(base: bytes):
    """Raw DEFLATE streams of the walk's adversarial shapes and their
    bytes: a 4 MiB zero run at level 9 (one literal, then dist-1 matches:
    one hop per 258 bytes, ~16,000 deep), 2 MiB of 64-byte blocks each a
    copy of the one before with one byte changed (copies of copies), and
    the two with one main-path stream as a merged batch."""
    rng = np.random.default_rng(11)
    zeros = bytes(4 << 20)
    cur = bytearray(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    nested = bytearray()
    for r in rng.integers(0, 64 * 256, 1 << 15):
        nested += cur
        cur[r % 64] = r // 64
    nested = bytes(nested)

    def deflate(data, level):
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        return c.compress(data) + c.flush()

    z, nst, txt = deflate(zeros, 9), deflate(nested, 9), make_streams(base, 1)[0]
    return {"zero_run": ([z], [zeros]), "nested": ([nst], [nested]),
            "merged": ([z, nst, txt], [zeros, nested, base])}


def chain_depths_of(mp, dev) -> dict:
    """chain_depths of a merged plan's matches, from the walk's lists."""
    w = walk_args(mp, dev)
    return chain_depths(w["init"].numel(), *w["lists"][:2])


def walk_args(mp, dev) -> dict:
    """A merged plan staged, through Phase A and compact: the walk's
    inputs (a fresh body, the dense lists, the literal tape) and the work
    a walk of them must do."""
    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.ops import phase_a as pa
    from debigulator_tpu_torch.ops import phase_b as pb

    st = inf.stage_plan(mp.plan, dev)
    a = pa.phase_a(st.pa, st.slots)
    rec = pb.prep_records(*a, st.pa.bob_cell, st.slots)
    mdst, mmeta, rdst, rmeta = pb.compact(rec, st.slots)
    return {"init": pb.init_body(st.n_seg, st.stored_pos, st.stored_val,
                                 device=dev),
            "lists": (mdst, mmeta, rdst, rmeta, rec.lit),
            "work": walk_work(a[5], a[1], st.slots, mp.plan.out_size)}


def greedy_cases(dev, filtered: np.ndarray, stride: int, chunk: int) -> dict:
    """(best_len, best_dist) on the card for the greedy walk: the encoder's
    own on `filtered` (the path's shape), `no_merge` (every len 3 at the
    same n: parses from different chunk starts never meet), the same with
    every len 11 (more residues than the kernel's speculative starts) and
    `cross_chunk` (literals, and a 258-long match over every boundary
    of the kernel's chunks, 1 to 257 positions before it)."""
    from debigulator_tpu_torch.ops import deflate_encode_device as enc

    n = len(filtered)
    dists = sorted({*enc.BASE_DISTANCES, stride, *enc.mine_distances(filtered)})
    bl, bd = enc.best_matches(gpu_filtered(filtered.tobytes(), dev), dists)
    rng = np.random.default_rng(7)
    far = torch.from_numpy(rng.integers(1, 32768, n).astype(np.int32)).to(dev)
    cross = torch.zeros(n, dtype=torch.int32, device=dev)
    bounds = torch.arange(chunk, max(n, chunk), chunk, device=dev)
    cross[bounds - 1 - bounds // chunk % 257] = 258
    return {"rgba1024_filtered": (bl, bd),
            "no_merge": (torch.full((n,), 3, dtype=torch.int32, device=dev), far),
            "no_merge_len11": (torch.full((n,), 11, dtype=torch.int32,
                                          device=dev), far),
            "cross_chunk": (cross, far), "dists": dists}


def decode_breakdown(png: bytes, dev) -> dict:
    """One decode_png_device call taken apart: its host steps, each timed
    alone (median of 3: CRC and chunk parse, the native scan, the inflate
    with the scan given, which holds the plan, the staging and the device
    decode; the rest is Adler-32, unfilter, RGBA and the read-back), and
    its device operations in one call under torch.profiler."""
    from debigulator_tpu_torch.models import pipeline as pl
    from debigulator_tpu_torch.models import png_codec
    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.ops.plan import CELL_BITS
    from debigulator_tpu_torch.ops.scanner import scan_stream_cells

    stream = png_codec.parse_chunks(png).idat[2:]
    scanned = scan_stream_cells(stream, CELL_BITS)
    out = {"e2e_ms": host_ms(lambda: pl.decode_png_device(png, device=dev)),
           "parse_crc_ms": host_ms(lambda: png_codec.parse_chunks(png)),
           "scan_ms": host_ms(lambda: scan_stream_cells(stream, CELL_BITS)),
           "inflate_ms": host_ms(lambda: (inf.inflate_device_dev(
               stream, scanned=scanned, device=dev), torch.cuda.synchronize()))}
    out["rest_ms"] = (out["e2e_ms"] - out["parse_crc_ms"] - out["scan_ms"]
                      - out["inflate_ms"])
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pl.decode_png_device(png, device=dev)
        out["profile_wall_ms"] = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    out["device_busy_ms"] = sum(e.self_device_time_total for e in events) / 1e3
    out["walk_ms"] = walk_device_ms(events)
    out["top"] = [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                  for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]]
    return out


def walk_phases(dev, base: bytes) -> dict:
    """The walk against its plain version on the adversarial shapes of
    walk_case_streams and on a body with a window prologue (the chunks of
    the long-stream decode, whose matches reach into the tail carried
    before them), each chain-depth histogram, and the kernel's and the
    plain version's times.  Returns the phase's line."""
    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.ops import phase_b as pb
    from debigulator_tpu_torch.ops.plan import CELL_BITS
    from debigulator_tpu_torch.ops.scanner import scan_stream_cells
    from debigulator_tpu_torch.parallel.merged import build_merged_plan

    shapes = []
    for name, (streams, datas) in walk_case_streams(base).items():
        mp = build_merged_plan(streams)
        w = walk_args(mp, dev)
        mdst, mmeta, rdst, rmeta, lit = w["lists"]
        got = pb.walk(w["init"].clone(), mdst, mmeta, rdst, rmeta, lit)
        torch.cuda.synchronize()
        want = pb.walk_plain(w["init"].clone(), mdst, mmeta, rdst, rmeta, lit)
        err = same(f"walk at {name}", (got,), (want,))
        body = got[pb.WINDOW : pb.WINDOW + mp.plan.out_size].to(torch.uint8)
        body = body.cpu().numpy()
        for off, data in zip(mp.out_offsets, datas, strict=True):
            if body[off : off + len(data)].tobytes() != data:
                raise AssertionError(f"walk at {name}: decode is not bit-exact")
        out = w["init"].clone()
        shapes.append({
            "shape": name, "streams": len(streams), "out_bytes": mp.plan.out_size,
            "max_abs_err": err, **w["work"],
            "depths": chain_depths(got.numel(), mdst, mmeta),
            "ms": time_ms(lambda: pb.walk(out, mdst, mmeta, rdst, rmeta,
                                          lit), 5),
            "plain_ms": time_ms(lambda: pb.walk_plain(
                w["init"].clone(), mdst, mmeta, rdst, rmeta, lit), 1),
            "bound_ms": w["work"]["bytes"] / HBM_BYTES_PER_S * 1e3})
        if not torch.equal(out, got):
            raise AssertionError(f"repeated walk at {name} changed its output")
        del w, got, want, out, body
    # A body with a window prologue: every walk of a chunked long-stream
    # decode after the first, held against the plain version.
    calls = []
    real_walk = pb.walk

    def keep_walk(out, mdst, mmeta, rdst, rmeta, lit):
        calls.append((out.clone(), mdst, mmeta, rdst, rmeta, lit))
        return real_walk(out, mdst, mmeta, rdst, rmeta, lit)

    long_data = base * 3
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    long_stream = c.compress(long_data) + c.flush()
    # The real walk counts its launches on the module's `walk`.
    keep_walk.launches = real_walk.launches
    pb.walk = keep_walk
    try:
        body, n = inf.inflate_device_long_stream(
            long_stream, *scan_stream_cells(long_stream, CELL_BITS),
            cap_rows=4096, device=dev)
    finally:
        pb.walk = real_walk
        real_walk.launches = keep_walk.launches
    if body[:n].to(torch.uint8).cpu().numpy().tobytes() != long_data:
        raise AssertionError("long-stream decode is not bit-exact")
    with_tail = [cl for cl in calls if bool(cl[0][: pb.WINDOW].any())]
    if not with_tail:
        raise AssertionError("no walk of the long stream had a window prologue")
    for init, mdst, mmeta, rdst, rmeta, lit in with_tail:
        same("walk with a window prologue",
             (pb.walk(init.clone(), mdst, mmeta, rdst, rmeta, lit),),
             (pb.walk_plain(init.clone(), mdst, mmeta, rdst, rmeta, lit),))
    return {"phase": "walk_vs_plain", "max_abs_err": 0, "shapes": shapes,
            "window_prologue": {"walks": len(calls),
                                "with_prologue": len(with_tail),
                                "max_abs_err": 0}}


def png_and_encode_phases(dev, corpus):
    """The second slice: the unfilter and greedy-walk kernels against their
    plain versions, the PNG decode path (``corpus``: make_corpus(0)) and
    the encode path.  Returns the
    two kernels' entries for the `kernels` line and extra `kernel_times`
    fields."""
    from debigulator_tpu_torch.models import pipeline as pl
    from debigulator_tpu_torch.models import png_codec
    from debigulator_tpu_torch.ops import _kernels
    from debigulator_tpu_torch.ops import deflate_encode_device as enc
    from debigulator_tpu_torch.ops import phase_a as pa
    from debigulator_tpu_torch.ops import phase_b as pb
    from debigulator_tpu_torch.ops import unfilter as uf

    counted = {"phase_a": pa.phase_a, "compact": pb.compact, "walk": pb.walk,
               "unfilter": uf.unfilter, "greedy_walk": enc.greedy_walk}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counted.items()}

    t0 = time.perf_counter()
    big_png, big_filtered, big_pix = big_image_png()
    make_s = time.perf_counter() - t0
    pngs = [c[1] for c in corpus]
    rgba_bytes = sum(c[2].nbytes for c in corpus)

    # --- unfilter kernel vs plain -------------------------------------
    rng = np.random.default_rng(2)
    shapes = []
    for h, w, bpp in ((16, 16, 4), (8, 24, 3), (33, 17, 1), (12, 5, 2),
                      (1, 7, 4), (9, 1, 3)):
        raw = rng.integers(0, 256, (3, h, 1 + w * bpp), dtype=np.uint8)
        raw[:, :, 0] = rng.integers(0, 5, (3, h))
        raw[0, 0, 0] = 9  # an out-of-range filter byte predicts None
        filt = torch.from_numpy(raw.reshape(3, -1)).to(dev)
        shapes.append(check_unfilter(f"small{h}x{w}x{bpp}", filt, h, w, bpp, uf))
        # One image of the batch alone, and all five filter types by hand.
        check_unfilter("single", filt[1], h, w, bpp, uf)
        host = uf.unfilter_image(raw[1].reshape(-1), h, w, bpp)
        if not np.array_equal(uf.unfilter(filt[1], h, w, bpp).cpu().numpy(), host):
            raise AssertionError("unfilter disagrees with the host oracle")
    by_shape: dict = {}
    for name, _, _, filtered, shape in corpus:
        by_shape.setdefault((name.rstrip("0123456789"), shape), []).append(filtered)
    for (name, (h, w, bpp)), members in by_shape.items():
        filt = torch.stack([gpu_filtered(f, dev) for f in members])
        shapes.append(check_unfilter(f"{name}x{len(members)}", filt, h, w, bpp, uf))
    one_rgba = gpu_filtered(corpus[0][3], dev)
    shapes.append(check_unfilter("rgba_one", one_rgba, *corpus[0][4], uf))
    big_filt = gpu_filtered(big_filtered, dev)
    shapes.append(check_unfilter("rgba_big", big_filt, BIG_SIDE, BIG_SIDE, 4,
                                 uf, reps=2))
    tall = tall_unfilter_checks(dev, uf, pl)
    emit({"phase": "unfilter_vs_plain", "max_abs_err": 0, "shapes": shapes,
          "tall": tall})
    del big_filt

    # --- greedy walk kernel vs plain ----------------------------------
    walks = []
    chunk = _kernels.constant("dbg_greedy_chunk")
    starts = _kernels.constant("dbg_greedy_starts")

    def check_walk(name, bl, bd, reps=3):
        got = enc.greedy_walk(bl, bd)
        torch.cuda.synchronize()
        want = enc.greedy_walk_plain(bl, bd)
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"greedy walk disagrees with its plain version at {name}")
        mlen = (got[1].long() >> 16).sum().item()
        visits = got[0].numel() + max(0, bl.numel() - mlen)
        rec = {"shape": name, "n": bl.numel(), "records": got[0].numel(),
               "visits": visits, "max_abs_err": err,
               "fixups": greedy_fixups(bl, chunk, starts),
               "ms": time_ms(lambda: enc.greedy_walk(bl, bd), reps),
               "plain_ms": time_ms(lambda: enc.greedy_walk_plain(bl, bd), reps),
               # visited lengths, taken distances, records (pos, meta), count
               "bound_ms": 4 * (visits + 3 * got[0].numel() + 1)
               / HBM_BYTES_PER_S * 1e3}
        walks.append(rec)
        return rec

    n = 10_000
    edge = {"none": np.zeros(n, np.int32), "cap258": np.full(n, 258, np.int32),
            "to_the_end": np.zeros(n, np.int32),
            "mixed": rng.choice([0, 1, 2, 3, 4, 6, 17, 40, 258], n).astype(np.int32)}
    edge["to_the_end"][[5, n - 10]] = [3, 10]
    for name, bl in edge.items():
        bd = rng.integers(1, 32768, n).astype(np.int32)
        check_walk(name, torch.from_numpy(bl).to(dev), torch.from_numpy(bd).to(dev))
    enc_filtered = np.frombuffer(corpus[0][3], np.uint8)  # 1024x1024 RGBA
    enc_h, enc_w, enc_ch = corpus[0][4]
    stride = 1 + enc_w * enc_ch
    g = greedy_cases(dev, enc_filtered, stride, chunk)
    walk_main = check_walk("rgba1024_filtered", *g["rgba1024_filtered"])
    for name in ("no_merge", "no_merge_len11", "cross_chunk"):
        check_walk(name, *g[name])
    dists = g["dists"]
    dev_data = gpu_filtered(corpus[0][3], dev)
    lengths_ms = time_ms(lambda: enc.best_matches(dev_data, dists), 2)
    emit({"phase": "greedy_walk_vs_plain", "max_abs_err": 0, "shapes": walks,
          "distances": dists, "lengths_ms": lengths_ms})
    del g

    # --- png_path ------------------------------------------------------
    def corpus_call(as_numpy=True):
        out = pl.decode_png_corpus_device(pngs, as_numpy=as_numpy, device=dev)
        torch.cuda.synchronize()
        return out

    reset()
    resolves: dict = {}
    real_resolve = spy(pb, "resolve", resolves)
    try:
        t0 = time.perf_counter()
        images = corpus_call()
        first_s = time.perf_counter() - t0
    finally:
        pb.resolve = real_resolve
    corpus_walk = walk_work_of(resolves["resolve"])
    del resolves
    for (name, _, want, _, _), got in zip(corpus, images, strict=True):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"corpus image {name} differs from its source")
    one = pl.decode_png_device(pngs[5], device=dev)
    batch = pl.decode_png_batch([pngs[6], pngs[11], pngs[13]], device=dev)
    for got, k in zip([one, *batch], (5, 6, 11, 13), strict=True):
        if not np.array_equal(got, corpus[k][2]):
            raise AssertionError(f"image {corpus[k][0]} differs from its source")
    png_launches = counts()
    require_launches("png_path", png_launches,
                     ("phase_a", "compact", "walk", "unfilter"))
    del images, one, batch
    e2e_ms = host_ms(corpus_call, 3)
    resident_ms = host_ms(lambda: corpus_call(as_numpy=False), 3)
    # A wrong Adler word must be caught by the device check.
    bad = bytearray(pngs[11])
    at = bad.index(b"IDAT")
    (length,) = struct.unpack_from(">I", bad, at - 4)
    bad[at + 4 + length - 1] ^= 0xFF
    bad[at + 4 + length : at + 8 + length] = struct.pack(
        ">I", zlib.crc32(bytes(bad[at : at + 4 + length])))
    try:
        pl.decode_png_device(bytes(bad), device=dev)
    except png_codec.PngError as e:
        adler_caught = str(e)
    else:
        raise AssertionError("a wrong Adler-32 word went unnoticed")
    # Host steps of the corpus call, each the median of 3 calls.
    from debigulator_tpu_torch.ops.plan import CELL_BITS
    from debigulator_tpu_torch.ops.scanner import scan_stream_cells

    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.parallel.merged import build_merged_plan

    parsed = [png_codec.parse_chunks(d) for d in pngs]
    streams = [ch.idat[2:] for ch in parsed]
    scans = [scan_stream_cells(s, CELL_BITS) for s in streams]
    mp = build_merged_plan(streams, scanned=scans)
    host = {
        "parse_crc_ms": host_ms(lambda: [png_codec.parse_chunks(d) for d in pngs]),
        "scan_serial_ms": host_ms(
            lambda: [scan_stream_cells(s, CELL_BITS) for s in streams]),
        "merged_plan_scanned_ms": host_ms(
            lambda: build_merged_plan(streams, scanned=scans)),
        "stage_ms": host_ms(lambda: (inf.stage_plan(mp.plan, dev),
                                     torch.cuda.synchronize())),
    }
    # Phase A of the corpus call, on the same plan: its slots and device
    # ms, one call replayed from a CUDA graph.
    st_c = inf.stage_plan(mp.plan, dev)
    corpus_phase_a = {"slots": st_c.slots,
                      "cells_pad": int(st_c.pa.cellw.shape[1]),
                      "replay_ms": replay_ms(
                          lambda: pa.phase_a(st_c.pa, st_c.slots))}
    del mp, scans, st_c
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        corpus_call(as_numpy=False)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    corpus_walk["ms_in_call"] = walk_device_ms(dev_events)
    corpus_walk["bound_ms"] = corpus_walk["bytes"] / HBM_BYTES_PER_S * 1e3
    reset()
    resolves = {}
    real_resolve = spy(pb, "resolve", resolves)
    try:
        t0 = time.perf_counter()
        big = pl.decode_png_device(big_png, device=dev)
        big_ms = (time.perf_counter() - t0) * 1e3
    finally:
        pb.resolve = real_resolve
    if not np.array_equal(big, big_pix):
        raise AssertionError("the large image differs from its source")
    big_launches = counts()
    require_launches("png_path, large image", big_launches,
                     ("phase_a", "compact", "walk", "unfilter"))
    big_walk = walk_work_of(resolves["resolve"])
    big_walk["bound_ms"] = big_walk["bytes"] / HBM_BYTES_PER_S * 1e3
    del big, resolves
    big_parts = decode_breakdown(big_png, dev)
    emit({"phase": "png_path", "images": len(pngs), "make_inputs_s": make_s,
          "compressed_bytes": sum(map(len, pngs)),
          "filtered_bytes": sum(len(c[3]) for c in corpus),
          "rgba_bytes": rgba_bytes, "exact": True, "first_call_s": first_s,
          "e2e_ms": e2e_ms, "e2e_mbps": rgba_bytes / e2e_ms / 1e3,
          "device_resident_ms": resident_ms,
          "device_resident_mbps": rgba_bytes / resident_ms / 1e3, **host,
          "profile_wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "busy_share": busy_ms / wall_ms,
          "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                  for e in top],
          "adler": "ok", "bad_adler_raises": adler_caught,
          "launches": png_launches, "walk": corpus_walk,
          "phase_a": corpus_phase_a,
          "big_image": {"side": BIG_SIDE, "png_bytes": len(big_png), "rgba_bytes": big_pix.nbytes,
                       "ms": big_ms, "mbps": big_pix.nbytes / big_ms / 1e3,
                       "exact": True, "launches": big_launches,
                       "walk": big_walk, "parts": big_parts}})
    del big_pix

    # --- encode_path ---------------------------------------------------
    src = corpus[0][2]  # 1024 x 1024 RGBA
    filtered = corpus[0][3]
    reset()
    t0 = time.perf_counter()
    stream = enc.deflate_fixed_device(filtered, stride=stride, device=dev)
    deflate_first_ms = (time.perf_counter() - t0) * 1e3
    if zlib.decompress(stream, -15) != filtered:
        raise AssertionError("the encoder's stream does not decode to its input")
    sel, _, _ = enc.lz77_select_device(enc_filtered, stride=stride, device=dev)
    # The device encoder, passed in: encode_png's default is the host one.
    def device_deflate(d):
        return enc.deflate_fixed_device(d, stride=stride, device=dev)

    png = png_codec.encode_png(src, deflate_fn=device_deflate, device=dev)
    if not np.array_equal(pl.decode_png_device(png, device=dev), src):
        raise AssertionError("encode_png -> decode_png_device is not the image")
    enc_launches = counts()
    require_launches("encode_path", enc_launches, ("greedy_walk", "unfilter"))
    deflate_ms = host_ms(lambda: enc.deflate_fixed_device(
        filtered, stride=stride, device=dev), 3)
    select_ms = host_ms(lambda: enc.lz77_select_device(
        enc_filtered, stride=stride, device=dev), 3)
    mine_ms = host_ms(lambda: enc.mine_distances(enc_filtered), 3)
    encode_png_ms = host_ms(lambda: png_codec.encode_png(
        src, deflate_fn=device_deflate, device=dev), 3)
    filt_dev = torch.from_numpy(src.reshape(enc_h, -1).copy()).to(dev)
    filter_ms = time_ms(lambda: uf.filter_image_best_device(
        filt_dev, enc_h, enc_w, enc_ch), 3)
    emit({"phase": "encode_path", "input_bytes": len(filtered),
          "stride": stride, "output_bytes": len(stream),
          "zlib6_bytes": len(zlib.compress(filtered, 6)) - 6,
          "matches": len(sel), "zlib_decodes": True, "round_trip_exact": True,
          "png_bytes": len(png), "first_call_ms": deflate_first_ms,
          "deflate_ms": deflate_ms, "deflate_mbps": len(filtered) / deflate_ms / 1e3,
          "select_ms": select_ms, "mine_ms": mine_ms, "lengths_ms": lengths_ms,
          "walk_ms": walk_main["ms"], "filter_search_ms": filter_ms,
          "encode_png_ms": encode_png_ms,
          "encode_png_mbps": src.nbytes / encode_png_ms / 1e3,
          "launches": enc_launches})

    bucket = next(r for r in shapes if r["shape"] == "rgbax6")
    kernels = [
        {"name": "unfilter", "route": "cuda",
         "source": "debigulator_tpu_torch/csrc/unfilter.cu",
         "replaces": "debigulator_tpu/ops/unfilter_pallas.py:49",
         "launches": png_launches["unfilter"], "max_abs_err": 0,
         "ms": bucket["ms"], "plain_ms": bucket["plain_ms"],
         "bound_ms": bucket["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "greedy_walk", "route": "cuda",
         "source": "debigulator_tpu_torch/csrc/greedy_walk.cu",
         "replaces": "debigulator_tpu/ops/deflate_encode_jnp.py:44",
         "launches": enc_launches["greedy_walk"], "max_abs_err": 0,
         "ms": walk_main["ms"], "plain_ms": walk_main["plain_ms"],
         "bound_ms": walk_main["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]
    times = {"unfilter_shape": "6 RGBA corpus images (one bucket of png_path)",
             "unfilter_shapes": [r for r in shapes
                                 if not r["shape"].startswith("small")],
             "greedy_walk_shape": f"best matches of {len(filtered)} filtered bytes",
             "greedy_walk_visits": walk_main["visits"],
             "greedy_walk_records": walk_main["records"]}
    return kernels, times


def match_v4_records(dev, stream: bytes, data: bytes):
    """Row 8 (``resolve_matches_v4``) against its plain twin and the serial
    walk: on one stream's match list (the v4 driver's shape: its token
    tape through match_v4_inputs, with ms, replayed ms, plain ms, scratch
    and bytes moved), on a hand-made list and on REWRITE_LISTS.  Returns
    (the stream's record, every shape's record)."""
    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.ops import lz77 as lz
    from debigulator_tpu_torch.ops import phase_a as pa
    from debigulator_tpu_torch.ops import plan as tp
    from debigulator_tpu_torch.parallel.merged import build_merged_plan

    # One stream's match list (the v4 driver's shape), then a
    # hand-made list on a random buffer: sources in the window tail, dist 1,
    # period 3, the full length 258, a match reading the one before it;
    # then the lists that rewrite bytes (REWRITE_LISTS).  Each against the
    # plain twin and the serial walk.
    one = build_merged_plan([stream])
    st1 = inf.stage_plan(one.plan, dev)
    cells1 = one.plan.num_cells
    tape1, _ = pa.phase_a_tape(st1.pa, st1.slots)
    out_size = one.plan.out_size
    out_rows = tp._round_pow2(
        -(-(out_size + lz.BODY_START + lz.MAXLEN + 512) // 128), 64)
    m_rows = tp._round_pow2(-(-(out_size // 3 + 130) // 128), 16)
    args8 = inf.match_v4_inputs(
        tape1[:cells1], torch.from_numpy(one.plan.cell_block).to(dev),
        torch.from_numpy(one.plan.block_out_base).to(dev), out_rows, m_rows,
        st1.stored_pos, st1.stored_val,
        torch.zeros(lz.WINDOW, dtype=torch.int32, device=dev))
    n8 = int(args8[3])
    got8 = lz.resolve_matches_v4(*args8[:3], n8)
    torch.cuda.synchronize()
    rec = {"shape": "path", "out_rows": out_rows, "m_rows": m_rows,
           "matches": n8, "max_abs_err": same(
               "lz77_match", (got8,),
               (lz.resolve_matches_v4_plain(*args8[:3], n8),)),
           "serial_err": serial_check("lz77_match", got8, *args8[:3], n8)}
    if got8.view(-1)[lz.BODY_START : lz.BODY_START + out_size].to(
            torch.uint8).cpu().numpy().tobytes() != data:
        raise AssertionError("lz77_match: decode is not bit-exact")
    rec["ms"] = time_ms(lambda: lz.resolve_matches_v4(*args8[:3], n8), 3)
    # Nothing is read back in a call: its device time alone.
    rec["replay_ms"] = replay_ms(lambda: lz.resolve_matches_v4(*args8[:3], n8))
    rec["plain_ms"] = time_ms(
        lambda: lz.resolve_matches_v4_plain(*args8[:3], n8), 1)
    rec["scratch_bytes"] = group_scratch_bytes(got8.numel(), n8,
                                               lz.MATCH_PIECE)
    rec["bytes"] = 4 * (2 * got8.numel() + 2 * n8)
    shapes = [rec]
    rng = np.random.default_rng(0)
    buf = torch.from_numpy(rng.integers(
        0, 256, (lz.BODY_START // 128 + 40, 128)).astype(np.int32)).to(dev)
    s0 = lz.BODY_START
    recs = [(s0, 258, 32768), (s0 + 258, 100, 1), (s0 + 358, 200, 3),
            (s0 + 600, 258, 258), (s0 + 858, 40, 20), (s0 + 900, 3, 30000),
            (s0 + 1000, 258, 142), (s0 + 1300, 77, 300), (s0 + 1400, 0, 7)]
    pos = torch.full((8 * 128,), s0, dtype=torch.int32)
    meta = torch.zeros(8 * 128, dtype=torch.int32)
    for i, (p, ln, d) in enumerate(recs):
        pos[i], meta[i] = p, (ln << 16) | d
    pos, meta = pos.view(8, 128).to(dev), meta.view(8, 128).to(dev)
    for n in (None, 5):
        got = lz.resolve_matches_v4(buf, pos, meta, n)
        shapes.append({
            "shape": "hand-made", "n_matches": n, "max_abs_err": same(
                "lz77_match hand-made", (got,),
                (lz.resolve_matches_v4_plain(buf, pos, meta, n),)),
            "serial_err": serial_check("lz77_match hand-made", got, buf, pos,
                                       meta, pos.numel() if n is None else n)})
    for name in REWRITE_LISTS:
        a = rewrite_list(dev, name, lz.BODY_START)
        got = lz.resolve_matches_v4(*a)
        shapes.append({
            "shape": name, "n_matches": a[3], "max_abs_err": same(
                f"lz77_match {name}", (got,),
                (lz.resolve_matches_v4_plain(*a),)),
            "serial_err": serial_check(f"lz77_match {name}", got, *a)})
    return rec, shapes


def fallback_phases(dev, base, streams):
    """The third slice: the token-tape Phase A and the three lz77 resolvers
    against their plain versions, then the speculative, v13, v7 and v3
    decode drivers over the main path's 29 streams.  Returns the four
    kernels' entries for the `kernels` line."""
    import os

    from debigulator_tpu_torch.ops import graph as tg
    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.ops import lz77 as lz
    from debigulator_tpu_torch.ops import phase_a as pa
    from debigulator_tpu_torch.ops import plan as tp
    from debigulator_tpu_torch.ops.scanner import _scan_stream_py
    from debigulator_tpu_torch.parallel.merged import (
        build_merged_plan,
        prepare_merged,
    )

    counted = {"phase_a": pa.phase_a, "phase_a_tape": pa.phase_a_tape,
               "lz77_match": lz.resolve_matches_v4,
               "lz77_tape": lz.resolve_tape_v6, "lz77_ops": lz.resolve_ops_v13}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counted.items()}

    datas = [zlib.decompress(s, -15) for s in streams]

    def check_streams(body, mp, what):
        got = body[: mp.plan.out_size].to(torch.uint8).cpu().numpy()
        for off, size, want in zip(mp.out_offsets, mp.out_sizes, datas):
            if got[off : off + size].tobytes() != want:
                raise AssertionError(f"{what}: decode is not bit-exact")

    def stored_of(st):
        return {"stored_pos": st.stored_pos, "stored_val": st.stored_val}

    # --- inputs at two shapes: two streams, and the main path's batch ----
    shapes = {}
    for label, k in (("small", 2), ("path", len(streams))):
        mp = build_merged_plan(streams[:k])
        st = inf.stage_plan(mp.plan, dev)
        shapes[label] = (mp, st, inf.n_segments(mp.plan.out_size))
    vs = {n: [] for n in ("phase_a_tape", "lz77_tape", "lz77_ops", "lz77_match")}
    timed = {}
    for label, (mp, st, n_seg) in shapes.items():
        slots, cells = st.slots, mp.plan.num_cells
        reps = 3 if label == "path" else 1
        # Row 6: the token tape.
        tape, cnts = pa.phase_a_tape(st.pa, slots)
        torch.cuda.synchronize()
        want = pa.phase_a_tape_plain(st.pa.cellw, st.pa.cell_block,
                                     st.pa.tables, slots)
        rec = {"shape": label, "cells_pad": int(tape.shape[0]), "slots": slots,
               "max_abs_err": same("phase_a_tape", (tape, cnts), want)}
        if label == "path":
            rec["ms"] = time_ms(lambda: pa.phase_a_tape(st.pa, slots), 10)
            rec["parts"] = device_parts(lambda: pa.phase_a_tape(st.pa, slots))
            rec["replay_ms"] = replay_ms(lambda: pa.phase_a_tape(st.pa, slots))
            rec["plain_ms"] = time_ms(lambda: pa.phase_a_tape_plain(
                st.pa.cellw, st.pa.cell_block, st.pa.tables, slots), 1)
            rec["bytes"] = 4 * (st.pa.cellw.numel() + tape.shape[0]
                                + st.pa.tables.numel() + tape.numel()
                                + cnts.numel())
            is_m = tape >= lz.TOK_MATCH_BIT
            rec["tokens"] = int((tape >= 0).sum())
            rec["matches"] = int(is_m.sum())
            timed["phase_a_tape"] = rec
        vs["phase_a_tape"].append(rec)
        del want

        # Row 7: the tape resolver over the whole body.
        args7 = inf.tape_v6_inputs(tape[:cells], cnts[:cells],
                                   st.pa.bob_cell[:cells], n_seg,
                                   st.stored_pos, st.stored_val)
        got7 = lz.resolve_tape_v6(*args7)
        torch.cuda.synchronize()
        rec = {"shape": label, "cells": cells, "out_rows": int(got7.shape[0]),
               "max_abs_err": same("lz77_tape", (got7,),
                                   (lz.resolve_tape_v6_plain(*args7),))}
        check_streams(inf._body_of(got7), mp, f"lz77_tape {label}")
        if label == "path":
            rec["ms"] = time_ms(lambda: lz.resolve_tape_v6(*args7), reps)
            rec["plain_ms"] = time_ms(
                lambda: lz.resolve_tape_v6_plain(*args7), 1)
            rec["parts"] = device_parts(lambda: lz.resolve_tape_v6(*args7))
            # The buffer read and written once, the valid tokens, and
            # each cell's count and base.
            rec["tokens"] = int(args7[2].clamp(max=slots).sum())
            rec["bytes"] = 4 * (2 * got7.numel() + rec["tokens"]
                                + 2 * args7[2].numel())
            timed["lz77_tape"] = rec
        vs["lz77_tape"].append(rec)

        # Row 9: the op resolver over the whole body.
        tapes = pa.phase_a(st.pa, slots)
        args9 = inf.ops_v13_inputs(*tapes, st.pa.bob_cell, n_seg,
                                   st.stored_pos, st.stored_val, slots)
        got9 = lz.resolve_ops_v13(*args9)
        torch.cuda.synchronize()
        rec = {"shape": label, "cells": int(tapes[0].shape[1]),
               "max_abs_err": same("lz77_ops", (got9,),
                                   (lz.resolve_ops_v13_plain(*args9),))}
        if not torch.equal(got9, got7):
            raise AssertionError("the tape and op resolvers disagree")
        if label == "path":
            rec["ms"] = time_ms(lambda: lz.resolve_ops_v13(*args9), reps)
            rec["plain_ms"] = time_ms(
                lambda: lz.resolve_ops_v13_plain(*args9), 1)
            rec["parts"] = device_parts(lambda: lz.resolve_ops_v13(*args9))
            # As row 7, with the valid records of the five tapes: two
            # words a match, two a run, one a literal.
            cnt9 = args9[6].long()
            rec["records"] = [int(((cnt9 >> sh) & 0xFF).sum())
                              for sh in (16, 8, 0)]
            n_m, n_r, n_l = rec["records"]
            rec["bytes"] = 4 * (2 * got9.numel() + 2 * n_m + 2 * n_r + n_l
                                + 2 * cnt9.numel())
            timed["lz77_ops"] = rec
        vs["lz77_ops"].append(rec)

        if label == "small":
            # A segment from the middle of the body: a non-zero window
            # tail, matches clipped at the segment's head and at its end.
            seg, off = 64 * 1024, 300_000
            flat = np.frombuffer(b"".join(datas[:2]), np.uint8)
            rows = (lz.BODY_START + seg) // 128 + lz.SLACK_ROWS
            init = torch.zeros(rows * 128, dtype=torch.int32)
            init[lz.PAD : lz.BODY_START] = torch.from_numpy(
                flat[off - lz.WINDOW : off].astype(np.int32))
            init = init.view(rows, 128).to(dev)
            want_seg = torch.from_numpy(
                flat[off : off + seg].astype(np.int32)).to(dev)
            for name, args, fn, plain in (
                    ("lz77_tape", args7, lz.resolve_tape_v6,
                     lz.resolve_tape_v6_plain),
                    ("lz77_ops", args9, lz.resolve_ops_v13,
                     lz.resolve_ops_v13_plain)):
                cbase = args[-5].view(-1)[: args[-3]]
                lo = int(torch.searchsorted(cbase, off, right=True)) - 1
                hi = int(torch.searchsorted(cbase, off + seg))
                call = (init, *args[1:-4], max(lo, 0), hi, off, args[-1])
                got = fn(*call)
                torch.cuda.synchronize()
                err = same(f"{name} segment", (got,), (plain(*call),))
                if not torch.equal(inf._body_of(got), want_seg):
                    raise AssertionError(f"{name}: segment is not bit-exact")
                vs[name].append({"shape": "segment", "seg_off": off,
                                 "seg_bytes": seg, "cell_lo": lo,
                                 "cell_hi": hi, "max_abs_err": err})
        del got7, got9, args7, args9, tapes, tape, cnts

    # Rows 7 and 9 on the walk's adversarial shapes (a zero run of dist-1
    # chains ~16,000 deep, copies of copies, both merged with a text
    # stream), each with its chain depths, then a call whose buffer has -1
    # in its pad and slack rows and whose tapes have -1 in every slot past
    # a cell's counts.  Every call exact against the plain twin and zlib.
    for name, (strms, dts) in walk_case_streams(base).items():
        mpw = build_merged_plan(strms)
        stw = inf.stage_plan(mpw.plan, dev)
        n_segw, slots_w = inf.n_segments(mpw.plan.out_size), stw.slots
        cells_w = mpw.plan.num_cells
        tape_w, cnts_w = pa.phase_a_tape(stw.pa, slots_w)
        a7 = inf.tape_v6_inputs(tape_w[:cells_w], cnts_w[:cells_w],
                                stw.pa.bob_cell[:cells_w], n_segw,
                                stw.stored_pos, stw.stored_val)
        a9 = inf.ops_v13_inputs(*pa.phase_a(stw.pa, slots_w), stw.pa.bob_cell,
                                n_segw, stw.stored_pos, stw.stored_val,
                                slots_w)
        depths = chain_depths_of(mpw, dev)
        for row, args, fn, plain in (
                ("lz77_tape", a7, lz.resolve_tape_v6, lz.resolve_tape_v6_plain),
                ("lz77_ops", a9, lz.resolve_ops_v13, lz.resolve_ops_v13_plain)):
            got = fn(*args)
            torch.cuda.synchronize()
            err = same(f"{row} at {name}", (got,), (plain(*args),))
            body = inf._body_of(got)[: mpw.plan.out_size].to(torch.uint8)
            body = body.cpu().numpy()
            for off, data in zip(mpw.out_offsets, dts, strict=True):
                if body[off : off + len(data)].tobytes() != data:
                    raise AssertionError(f"{row} at {name}: not bit-exact")
            vs[row].append({
                "shape": name, "streams": len(strms),
                "out_bytes": mpw.plan.out_size, "slots": slots_w,
                "max_abs_err": err, "depths": depths,
                "ms": time_ms(lambda: fn(*args), 3),
                "plain_ms": time_ms(lambda: plain(*args), 1)})
            del got, body
        del a7, a9, tape_w, cnts_w, stw
    mp2, st2, n_seg2 = shapes["small"]
    cells2, slots2 = mp2.plan.num_cells, st2.slots
    tape2, cnts2 = pa.phase_a_tape(st2.pa, slots2)
    a7 = list(inf.tape_v6_inputs(tape2[:cells2], cnts2[:cells2],
                                 st2.pa.bob_cell[:cells2], n_seg2,
                                 st2.stored_pos, st2.stored_val))
    a9 = list(inf.ops_v13_inputs(*pa.phase_a(st2.pa, slots2),
                                 st2.pa.bob_cell, n_seg2, st2.stored_pos,
                                 st2.stored_val, slots2))

    def pad_past_counts(tapes, n_valid):
        """-1 in every slot of the cell-major `tapes` from n_valid on."""
        pad = torch.arange(slots2, device=dev)[None, :] >= n_valid[:, None]
        for t in tapes:
            t.view(-1)[: pad.numel()].view(-1, slots2)[pad] = -1

    c7, c9 = a7[2].view(-1).long(), a9[6].view(-1).long()
    pad_past_counts(a7[1:2], c7.clamp(max=slots2))
    pad_past_counts(a9[1:3], c9 >> 16)
    pad_past_counts(a9[3:5], (c9 >> 8) & 0xFF)
    pad_past_counts(a9[5:6], c9 & 0xFF)
    for args in (a7, a9):
        flat = args[0].view(-1)
        flat[: lz.PAD] = -1
        flat[-lz.SLACK_ROWS * 128 :] = -1
    for row, args, fn, plain in (
            ("lz77_tape", a7, lz.resolve_tape_v6, lz.resolve_tape_v6_plain),
            ("lz77_ops", a9, lz.resolve_ops_v13, lz.resolve_ops_v13_plain)):
        got = fn(*args)
        torch.cuda.synchronize()
        err = same(f"{row} with -1 padding", (got,), (plain(*args),))
        flat = got.view(-1)
        if bool((flat[: lz.PAD] != -1).any()) or bool(
                (flat[-lz.SLACK_ROWS * 128 :] != -1).any()):
            raise AssertionError(f"{row}: the pad or slack rows were stored")
        check_streams(inf._body_of(got), mp2, f"{row} with -1 padding")
        vs[row].append({"shape": "minus_one_padding", "streams": 2,
                        "max_abs_err": err})
    del a7, a9, tape2, cnts2, got

    # Row 8 (match_v4_records).
    timed["lz77_match"], shp = match_v4_records(dev, streams[0], datas[0])
    vs["lz77_match"] += shp
    for name, shp in vs.items():
        emit({"phase": f"{name}_vs_plain", "max_abs_err": 0, "shapes": shp})

    # --- fallback_paths: four drivers over the 29 streams ------------------
    # Each path is driven once with the counts set to 0 just before it and
    # read just after; timing repeats and stage replays come after the read.
    paths = {}
    mp, st, n_seg = shapes["path"]

    # speculative: Python scans, merged speculative plan -> v5.
    t0 = time.perf_counter()
    scanned = [(*_scan_stream_py(s), None) for s in streams]
    scan_s = time.perf_counter() - t0
    reset()
    t0 = time.perf_counter()
    mp_spec = build_merged_plan(streams, scanned=scanned)
    plan_ms = (time.perf_counter() - t0) * 1e3
    if mp_spec.plan.exact_entries or mp_spec.plan.slots_exact:
        raise AssertionError("the Python scan must give a speculative plan")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = prepare_merged(mp_spec, device=dev)  # stages, probes the slots
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    body = run()
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    d5 = counts()
    peak = torch.cuda.max_memory_allocated()
    check_streams(body, mp_spec, "speculative v5")
    require_launches("fallback_paths, speculative v5", d5, ("lz77_tape",))
    del body, run
    # The same decode by its stages, outside the path's counted run.
    arrays = tp.plan_arrays_v3(mp_spec.plan, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt, meta_g = tg.build_graph(arrays, mp_spec.plan.n_bits)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tape, overflow, cnts, sweeps = tg.chase_cells(
        nxt, meta_g, arrays["cell_entry"], mp_spec.plan.n_bits,
        mp_spec.plan.slots)
    torch.cuda.synchronize()
    chase_ms = (time.perf_counter() - t0) * 1e3
    del nxt, meta_g
    t0 = time.perf_counter()
    inf.resolve_tape_segmented_v6(tape, cnts, arrays["bob_cell"], n_seg,
                                  arrays["stored_pos"], arrays["stored_val"])
    torch.cuda.synchronize()
    resolve_ms = (time.perf_counter() - t0) * 1e3
    # The fixpoint must land on the scanner's exact tape.
    exact_tape, _ = pa.phase_a_tape(st.pa, mp_spec.plan.slots)
    if bool(overflow) or not torch.equal(
            tape, exact_tape[: mp_spec.plan.num_cells]):
        raise AssertionError("the speculative tape is not the exact tape")
    paths["speculative_v5"] = {
        "python_scan_s": scan_s, "merged_plan_ms": plan_ms,
        "prepare_ms": prepare_ms, "run_ms": run_ms, "sweeps": sweeps,
        "graph_ms": graph_ms, "chase_ms": chase_ms, "resolve_ms": resolve_ms,
        "peak_memory_bytes": peak, "n_bits": mp_spec.plan.n_bits,
        "slots": mp_spec.plan.slots, "launches": d5}
    del tape, cnts, arrays, exact_tape, mp_spec, scanned
    torch.cuda.empty_cache()

    # speculative, one stream under OUT_CAP, through the entry point -> v4.
    reset()
    os.environ["DBG_NO_NATIVE"] = "1"
    try:
        t0 = time.perf_counter()
        got = inf.inflate_device(streams[0], device=dev)
        v4_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del os.environ["DBG_NO_NATIVE"]
    d4 = counts()
    if got != datas[0] or len(got) + 512 > lz.OUT_CAP:
        raise AssertionError("speculative v4: decode is not bit-exact")
    require_launches("fallback_paths, speculative v4", d4, ("lz77_match",))
    paths["speculative_v4"] = {"out_bytes": len(got), "ms_with_scan": v4_ms,
                               "launches": d4}

    # v13: the exact merged plan under DBG_PHASE_B=v13.
    reset()
    os.environ["DBG_PHASE_B"] = "v13"
    try:
        run = prepare_merged(mp, device=dev)
        body = run()
        torch.cuda.synchronize()
        d13 = counts()
        v13_ms = host_ms(lambda: (run(), torch.cuda.synchronize()), 3)
    finally:
        del os.environ["DBG_PHASE_B"]
    check_streams(body, mp, "v13")
    require_launches("fallback_paths, v13", d13, ("phase_a", "lz77_ops"))
    # Its Phase B alone: the glue and row 9 on the staged Phase A tapes.
    tapes = pa.phase_a(st.pa, st.slots)
    r13_ms = host_ms(lambda: (inf.resolve_ops_segmented_v13(
        *tapes, st.pa.bob_cell, n_seg, st.stored_pos, st.stored_val,
        st.slots), torch.cuda.synchronize()), 3)
    paths["v13"] = {"device_ms": v13_ms, "resolve_ms": r13_ms,
                    "launches": d13}
    del body, run, tapes

    # v7: the token-tape Phase A and the tape resolver.
    reset()
    body, overflow = inf.inflate_v7(st.pa, stored_of(st), st.slots, n_seg,
                                    mp.plan.num_cells)
    torch.cuda.synchronize()
    d7 = counts()
    if bool(overflow):
        raise AssertionError("v7 overflowed the scanner's exact slots")
    check_streams(body, mp, "v7")
    v7_ms = host_ms(lambda: (inf.inflate_v7(st.pa, stored_of(st), st.slots,
                                            n_seg, mp.plan.num_cells),
                             torch.cuda.synchronize()), 3)
    require_launches("fallback_paths, v7", d7, ("phase_a_tape", "lz77_tape"))
    # Its Phase B alone: the glue and row 7 on the staged token tape.
    cells = mp.plan.num_cells
    tape, cnts = pa.phase_a_tape(st.pa, st.slots)
    r7_ms = host_ms(lambda: (inf.resolve_tape_segmented_v6(
        tape[:cells], cnts[:cells], st.pa.bob_cell[:cells], n_seg,
        st.stored_pos, st.stored_val), torch.cuda.synchronize()), 3)
    paths["v7"] = {"device_ms": v7_ms, "resolve_ms": r7_ms, "launches": d7}
    del body, tape, cnts

    # v3: one stream, all tensor ops, no kernel of the port.
    reset()
    t0 = time.perf_counter()
    got = inf.inflate_device(streams[1], device=dev, use_kernels=False)
    v3_ms = (time.perf_counter() - t0) * 1e3
    if got != datas[1] or any(counts().values()):
        raise AssertionError("v3: not bit-exact, or it launched a kernel")
    paths["v3"] = {"out_bytes": len(got), "ms_with_scan": v3_ms}
    # Each kernel's launches: the sum over the paths' own counted runs.
    launches = {k: d5[k] + d4[k] + d13[k] + d7[k] for k in counted}
    emit({"phase": "fallback_paths", "streams": len(streams),
          "out_bytes": sum(map(len, datas)), "bit_exact": True, **paths,
          "launches": launches})

    sources = {
        "phase_a_tape": ("debigulator_tpu_torch/csrc/phase_a.cu",
                         "debigulator_tpu/ops/phase_a_pallas.py:232"),
        "lz77_tape": ("debigulator_tpu_torch/csrc/lz77_tape.cu",
                      "debigulator_tpu/ops/lz77_pallas.py:317"),
        "lz77_match": ("debigulator_tpu_torch/csrc/lz77_match.cu",
                       "debigulator_tpu/ops/lz77_pallas.py:145"),
        "lz77_ops": ("debigulator_tpu_torch/csrc/lz77_ops.cu",
                     "debigulator_tpu/ops/lz77_pallas.py:581"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        rec = timed[name]
        b_ms = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        o_ms = 0.0
        if name == "phase_a_tape":
            o_ms = (OPS_PER_SYMBOL * (rec["tokens"] + rec["matches"])
                    / ALU_OPS_PER_S * 1e3)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            **({"via": GROUP_CHASE_VIA} if name == "lz77_match" else {}),
            "launches": launches[name], "max_abs_err": 0, "ms": rec["ms"],
            **{k: rec[k] for k in ("replay_ms", "scratch_bytes", "events")
               if k in rec},
            "plain_ms": rec["plain_ms"], "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None})
    return kernels


def archive_phases(dev, base, streams):
    """The fourth slice: the host-fed group resolver, the v14 compaction
    and walk and the v1 tape resolver against their plain versions (rows
    10a and 10c also on the walk's adversarial shapes), then the host-fed
    v10, v14 and v1 paths over the main path's streams.  Returns the four
    kernels' entries for the `kernels` line."""
    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.ops import lz77 as lz
    from debigulator_tpu_torch.ops import phase_a as pa
    from debigulator_tpu_torch.ops import plan as tp
    from debigulator_tpu_torch.ops.archive import inflate_generations as ig
    from debigulator_tpu_torch.ops.archive import lz77_generations as lg
    from debigulator_tpu_torch.parallel.merged import build_merged_plan
    from debigulator_tpu_torch.tools import profile_merged as pm

    counted = {"groups_v11": lg.resolve_groups_v11,
               "compact_v14": lg.compact_v14,
               "walk_v14": lg.resolve_walk_v14,
               "tape_v1": lg.resolve_tape_v1, "phase_a": pa.phase_a}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counted.items()}

    datas = [zlib.decompress(s, -15) for s in streams]

    def body_of(out2d, n):
        return out2d.view(-1)[lg.BODY_START : lg.BODY_START + n]

    def segment_buffer(flat, off, seg):
        return window_buffer(flat, off, torch.zeros(seg, dtype=torch.int32),
                             dev)

    def v11_inputs(strms):
        """Row 10a's arguments for a batch: its host-fed piece arrays over
        a body that holds the stored bytes."""
        mp, v9, stored, n_seg, _ = pm.host_fed_inputs(strms, dev)
        body0 = torch.zeros(n_seg * tp.SEG_BYTES, dtype=torch.int32,
                            device=dev)
        ig._place_stored(body0, *stored)
        return mp, v9, n_seg, (ig._buffer(body0), v9["lims"], v9["gpos"],
                               v9["gmeta"], v9["lpos"], v9["lmeta"], v9["lit"])

    def v11_work(mp, v9, args):
        """Row 10a's work: live match and literal pieces, and the bytes a
        call must move (the buffer read and written once, two words a
        live piece, the literal bytes, the limits) with their bound."""
        gpos = v9["gpos"].view(-1)
        n_pieces = int((((gpos & 255) - ((gpos >> 8) & 127)) > 0).sum())
        n_lp = int((v9["lims"][:, 4] - v9["lims"][:, 3]).sum())
        n = 4 * (2 * args[0].numel() + 2 * (n_pieces + n_lp)
                 + len(mp.recs["lit"]) + v9["lims"].numel())
        return {"pieces": n_pieces, "literal_pieces": n_lp, "bytes": n,
                "bound_ms": n / HBM_BYTES_PER_S * 1e3}

    def v14_records(c_args):
        """(matches, runs, literals) in the cells of compact_v14's args."""
        cnt = c_args[5].view(-1).long()
        return tuple(int(((cnt >> sh) & 0xFF).sum()) for sh in (16, 8, 0))

    def v14_work(c_args, w_args):
        """Row 10c's work: matches and runs, and the bytes a call must
        move (the buffer read and written once, two words a match and a
        run, the literal bytes) with their bound."""
        n_m, n_r, n_l = v14_records(c_args)
        n = 4 * (2 * w_args[0].numel() + 2 * n_m + 2 * n_r + n_l)
        return {"matches": n_m, "runs": n_r, "bytes": n,
                "bound_ms": n / HBM_BYTES_PER_S * 1e3}

    def v14_inputs(strms):
        """Rows 10b's and 10c's arguments as the v14 glue makes them for a
        batch, and the glue's segment_lims arguments."""
        mpf = build_merged_plan(strms)
        st = inf.stage_plan(mpf.plan, dev)
        arrays = tp.plan_arrays_v7(mpf.plan, dev)
        seen = {}
        real_c = spy(lg, "compact_v14", seen)
        real_w = spy(lg, "resolve_walk_v14", seen)
        real_l = spy(ig, "segment_lims", seen)
        try:
            ig.inflate_v14(st.pa, arrays, mpf.plan.slots, st.n_seg)
        finally:
            lg.compact_v14, lg.resolve_walk_v14 = real_c, real_w
            ig.segment_lims = real_l
        return (mpf, seen["compact_v14"][-1][0], seen["resolve_walk_v14"][-1][0],
                seen["segment_lims"][-1][0])

    # --- the four kernels vs their plain versions ----------------------
    vs = {n: [] for n in ("groups_v11", "compact_v14", "walk_v14", "tape_v1")}
    timed = {}
    for label, k in (("small", 2), ("path", len(streams))):
        reps = 3 if label == "path" else 1
        # Row 10a on the host-fed inputs of the batch.
        mp, v9, n_seg, args = v11_inputs(streams[:k])
        total = n_seg * tp.SEG_BYTES
        got = lg.resolve_groups_v11(*args)
        torch.cuda.synchronize()
        rec = {"shape": label, "streams": k, "n_seg": n_seg,
               "max_abs_err": same("groups_v11", (got,),
                                   (lg.resolve_groups_v11_plain(*args),))}
        pm.check(body_of(got, total), mp, datas[:k])
        if label == "path":
            rec["ms"] = time_ms(lambda: lg.resolve_groups_v11(*args), reps)
            # Nothing is read back in a call: its device time alone.
            rec["replay_ms"] = replay_ms(lambda: lg.resolve_groups_v11(*args))
            rec["plain_ms"] = time_ms(
                lambda: lg.resolve_groups_v11_plain(*args), 1)
            rec.update(v11_work(mp, v9, args))
            rec["scratch_bytes"] = group_scratch_bytes(args[0].numel(),
                                                       args[2].numel())
            timed["groups_v11"] = rec
        vs["groups_v11"].append(rec)
        if label == "small":
            # One 512 KiB segment of the packing alone (its window the
            # bytes before it), the reference's kernel-call shape.
            flat = np.frombuffer(b"".join(datas[:k]), np.uint8)
            one = (segment_buffer(flat, tp.SEG_BYTES, tp.SEG_BYTES),
                   v9["lims"][1].contiguous(), *args[2:])
            got1 = lg.resolve_groups_v11(*one)
            torch.cuda.synchronize()
            err = same("groups_v11 segment", (got1,),
                       (lg.resolve_groups_v11_plain(*one),))
            n1 = min(tp.SEG_BYTES, len(flat) - tp.SEG_BYTES)
            if not np.array_equal(body_of(got1, n1).cpu().numpy(),
                                  flat[tp.SEG_BYTES : tp.SEG_BYTES + n1]):
                raise AssertionError("groups_v11: segment is not bit-exact")
            vs["groups_v11"].append({"shape": "segment 1", "max_abs_err": err})
        del got, args, v9

        # Rows 10b and 10c on the v14 glue's own inputs.
        mpf, c_args, w_args, l_args = v14_inputs(streams[:k])
        got_c = lg.compact_v14(*c_args)
        torch.cuda.synchronize()
        rec = {"shape": label, "cells": int(c_args[5].numel()),
               "max_abs_err": same("compact_v14", got_c,
                                   lg.compact_v14_plain(*c_args))}
        got_w = lg.resolve_walk_v14(*w_args)
        torch.cuda.synchronize()
        rec_w = {"shape": label, "max_abs_err": same(
            "walk_v14", (got_w,), (lg.resolve_walk_v14_plain(*w_args),))}
        pm.check(body_of(got_w, mpf.plan.out_size), mpf, datas[:k])
        if label == "small":
            rec_w["serial_err"] = serial_v14_check("walk_v14", got_w, *w_args)
        if label == "path":
            slots = c_args[-1]
            cnt = c_args[5].view(-1).long()
            n_m, n_r, n_l = v14_records(c_args)
            slot = torch.arange(slots, device=dev)[None, :]
            valid = [(slot < ((cnt >> sh) & 0xFF).clamp(max=slots)[:, None]
                      ).view(-1) for sh in (16, 8, 0)]

            def library_v14():
                # Each of the five arrays the wrapper compacts through
                # masked_select (no zero padding).
                return [torch.masked_select(c_args[i].view(-1), valid[v])
                        for i, v in ((0, 0), (1, 0), (2, 1), (3, 1), (4, 2))]

            rec["ms"] = time_ms(lambda: lg.compact_v14(*c_args), 10)
            rec["plain_ms"] = time_ms(lambda: lg.compact_v14_plain(*c_args), 3)
            rec["library_ms"] = time_ms(library_v14, 10)
            rec["library_one_array_ms"] = time_ms(lambda: torch.masked_select(
                c_args[0].view(-1), valid[0]), 10)
            rec["records"] = [n_m, n_r, n_l]
            # The valid records read once with each cell's count and three
            # offsets; every slot of the five outputs written once.
            rec["bytes"] = 4 * (2 * n_m + 2 * n_r + n_l + 4 * cnt.numel()
                                + sum(t.numel() for t in got_c))
            timed["compact_v14"] = rec
            rec_w["ms"] = time_ms(lambda: lg.resolve_walk_v14(*w_args), reps)
            # The call reads its limits first; its launches alone, with the
            # limits read once, replayed from a CUDA graph.
            limits = lg._walk_limits(w_args[0], w_args[1])
            out_w = w_args[0].clone()
            rec_w["replay_ms"] = replay_ms(
                lambda: lg.walk_v14_launch(out_w, limits, *w_args[1:]))
            if not torch.equal(out_w, got_w):
                raise AssertionError("walk_v14: the replayed launches differ")
            rec_w["plain_ms"] = time_ms(
                lambda: lg.resolve_walk_v14_plain(*w_args), 1)
            rec_w["scratch_bytes"] = group_scratch_bytes(
                got_w.numel(), limits[1] - limits[0], lz.MATCH_PIECE)
            rec_w.update(v14_work(c_args, w_args))
            timed["walk_v14"] = rec_w
        vs["compact_v14"].append(rec)
        vs["walk_v14"].append(rec_w)
        if label == "small":
            # An 8 KiB segment from the middle of the body: window tail,
            # matches clipped at its head and end.
            seg = 8192
            off = 300_000 // seg * seg
            flat = np.frombuffer(b"".join(datas[:k]), np.uint8)
            lims = ig.segment_lims(*l_args[:6], -(-len(flat) // seg),
                                   seg_bytes=seg)[off // seg]
            call = (segment_buffer(flat, off, seg), lims.contiguous(),
                    *w_args[2:])
            got_s = lg.resolve_walk_v14(*call)
            torch.cuda.synchronize()
            err = same("walk_v14 segment", (got_s,),
                       (lg.resolve_walk_v14_plain(*call),))
            if not np.array_equal(body_of(got_s, seg).cpu().numpy(),
                                  flat[off : off + seg]):
                raise AssertionError("walk_v14: segment is not bit-exact")
            vs["walk_v14"].append({"shape": "segment", "seg_off": off,
                                   "seg_bytes": seg, "max_abs_err": err})
        del got_c, got_w, c_args, w_args, l_args

    # Rows 10a and 10c on the walk's adversarial shapes (a zero run of
    # dist-1 matches, copies of copies, both merged with a text stream):
    # exact against the plain twin and zlib, each with its ms and plain
    # ms, row 10a also replayed from a CUDA graph.
    for name, (strms, dts) in walk_case_streams(base).items():
        mp, v9, n_seg, args = v11_inputs(strms)
        got = lg.resolve_groups_v11(*args)
        torch.cuda.synchronize()
        err = same(f"groups_v11 at {name}", (got,),
                   (lg.resolve_groups_v11_plain(*args),))
        pm.check(body_of(got, n_seg * tp.SEG_BYTES), mp, dts)
        vs["groups_v11"].append({
            "shape": name, "streams": len(strms),
            "out_bytes": mp.plan.out_size, "max_abs_err": err,
            "ms": time_ms(lambda: lg.resolve_groups_v11(*args), 3),
            "replay_ms": replay_ms(lambda: lg.resolve_groups_v11(*args)),
            "plain_ms": time_ms(lambda: lg.resolve_groups_v11_plain(*args), 1),
            "scratch_bytes": group_scratch_bytes(args[0].numel(),
                                                 args[2].numel()),
            **v11_work(mp, v9, args)})
        del got, args, v9
        mpf, c_args, w_args, _ = v14_inputs(strms)
        got = lg.resolve_walk_v14(*w_args)
        torch.cuda.synchronize()
        err = same(f"walk_v14 at {name}", (got,),
                   (lg.resolve_walk_v14_plain(*w_args),))
        pm.check(body_of(got, mpf.plan.out_size), mpf, dts)
        vs["walk_v14"].append({
            "shape": name, "streams": len(strms),
            "out_bytes": mpf.plan.out_size, "slots": mpf.plan.slots,
            "max_abs_err": err,
            "ms": time_ms(lambda: lg.resolve_walk_v14(*w_args), 3),
            "plain_ms": time_ms(lambda: lg.resolve_walk_v14_plain(*w_args), 1),
            **v14_work(c_args, w_args)})
        del got, c_args, w_args

    # Row 10c on dense lists that write bytes twice, in and out of groups
    # marked clean (v14_rewrite_case): against the plain twin and the
    # serial walk.
    for name in ("rewritten", "clean_across_segments"):
        args = v14_rewrite_case(dev, name)
        got = lg.resolve_walk_v14(*args)
        vs["walk_v14"].append({
            "shape": name, "max_abs_err": same(
                f"walk_v14 {name}", (got,),
                (lg.resolve_walk_v14_plain(*args),)),
            "serial_err": serial_v14_check(f"walk_v14 {name}", got, *args)})

    # Row 10a on hand-made lists that break the packer's rules
    # (group_case): the group semantics against the plain twin.
    for shape in GROUP_SHAPES:
        vs["groups_v11"].append(group_shape_record(
            dev, "v11", shape, lg.resolve_groups_v11,
            lg.resolve_groups_v11_plain))

    # Row 10d: one stream's token tape from the tensor-op Phase A.
    one = build_merged_plan(streams[:1])
    arrays1 = tp.plan_arrays_v3(one.plan, dev)
    tape, overflow, cnt1, _ = inf.tape_v3(arrays1, one.plan.n_bits,
                                          one.plan.slots, exact=True)
    if bool(overflow):
        raise AssertionError("tape_v3 overflowed the exact slots")
    out_size = one.plan.out_size
    got1 = lg.resolve_tape_v1(tape, cnt1, out_size)
    torch.cuda.synchronize()
    rec = {"shape": "path", "cells": int(tape.shape[0]),
           "slots": int(tape.shape[1]), "max_abs_err": same(
               "tape_v1", (got1,),
               (lg.resolve_tape_v1_plain(tape, cnt1, out_size),))}
    if got1.cpu().numpy().tobytes() != datas[0]:
        raise AssertionError("tape_v1: decode is not bit-exact")
    rec["ms"] = time_ms(lambda: lg.resolve_tape_v1(tape, cnt1, out_size), 3)
    rec["plain_ms"] = time_ms(
        lambda: lg.resolve_tape_v1_plain(tape, cnt1, out_size), 1)
    rec["tokens"] = int(cnt1.clamp(max=tape.shape[1]).sum())
    # The valid tokens and each cell's count read once, the bytes out.
    rec["bytes"] = 4 * (rec["tokens"] + cnt1.numel()) + out_size
    timed["tape_v1"] = rec
    vs["tape_v1"].append(rec)
    vs["compact_v14"].append(compact_v14_edge_case(dev))
    for name, shp in vs.items():
        emit({"phase": f"{name}_vs_plain", "max_abs_err": 0, "shapes": shp})

    # --- archive_paths: host-fed v10, v14 and v1 over the streams -----------
    # Each path is driven once with the counts set to 0 just before it and
    # read just after; timing repeats come after the read.
    paths = {}
    reset()
    mp, v9, stored, n_seg, host = pm.host_fed_inputs(streams, dev)
    body = ig.inflate_v10(v9, *stored, n_seg)
    torch.cuda.synchronize()
    d10 = counts()
    pm.check(body, mp, datas)
    require_launches("archive_paths, host-fed v10", d10, ("groups_v11",))
    # The host steps again, the median of 3 calls each.
    again = [pm.host_fed_inputs(streams, dev)[4] for _ in range(3)]
    host = {f"first_{k}": v for k, v in host.items()} | {
        k: float(np.median([a[k] for a in again])) for k in host}
    paths["host_fed_v10"] = {
        **host, "device_ms": host_ms(lambda: (ig.inflate_v10(
            v9, *stored, n_seg), torch.cuda.synchronize())),
        "pieces_words": int(v9["gpos"].numel()),
        "literal_bytes": len(mp.recs["lit"]), "slots": mp.plan.slots,
        "launches": d10}
    del body, v9, stored

    mpf = build_merged_plan(streams)
    st = inf.stage_plan(mpf.plan, dev)
    arrays = tp.plan_arrays_v7(mpf.plan, dev)
    torch.cuda.synchronize()
    reset()
    body, overflow = ig.inflate_v14(st.pa, arrays, mpf.plan.slots, st.n_seg)
    torch.cuda.synchronize()
    d14 = counts()
    if bool(overflow):
        raise AssertionError("v14 overflowed the scanner's exact slots")
    pm.check(body, mpf, datas)
    require_launches("archive_paths, v14", d14,
                     ("phase_a", "compact_v14", "walk_v14"))
    paths["v14"] = {"device_ms": host_ms(lambda: (ig.inflate_v14(
        st.pa, arrays, mpf.plan.slots, st.n_seg), torch.cuda.synchronize())),
        "launches": d14}
    del body, st, arrays

    reset()
    t0 = time.perf_counter()
    tape, overflow, cnt1, _ = inf.tape_v3(arrays1, one.plan.n_bits,
                                          one.plan.slots, exact=True)
    got1 = lg.resolve_tape_v1(tape, cnt1, out_size)
    torch.cuda.synchronize()
    v1_ms = (time.perf_counter() - t0) * 1e3
    d1 = counts()
    if got1.cpu().numpy().tobytes() != datas[0]:
        raise AssertionError("v1: decode is not bit-exact")
    require_launches("archive_paths, v1", d1, ("tape_v1",))
    paths["v1"] = {"out_bytes": out_size, "tape_v3_and_resolve_ms": v1_ms,
                   "launches": d1}
    launches = {k: d10[k] + d14[k] + d1[k] for k in counted}
    emit({"phase": "archive_paths", "streams": len(streams),
          "out_bytes": sum(map(len, datas)), "bit_exact": True, **paths,
          "launches": launches})

    sources = {
        "groups_v11": ("debigulator_tpu_torch/csrc/groups_v11.cu",
                       "debigulator_tpu/ops/archive/lz77_generations.py:609"),
        "compact_v14": ("debigulator_tpu_torch/csrc/compact_v14.cu",
                        "debigulator_tpu/ops/archive/lz77_generations.py:893"),
        "walk_v14": ("debigulator_tpu_torch/csrc/walk_v14.cu",
                     "debigulator_tpu/ops/archive/lz77_generations.py:1015"),
        "tape_v1": ("debigulator_tpu_torch/csrc/lz77_tape.cu",
                    "debigulator_tpu/ops/archive/lz77_generations.py:49"),
    }
    # The resolvers whose matches go through a grid-wide chase.
    via_chase = {"groups_v11": GROUP_CHASE_VIA, "walk_v14": GROUP_CHASE_VIA,
                 "tape_v1": "debigulator_tpu_torch/csrc/chase.cuh"}
    kernels = []
    for name, (src, replaces) in sources.items():
        rec = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            **({"via": via_chase[name]} if name in via_chase else {}),
            "launches": launches[name], "max_abs_err": 0, "ms": rec["ms"],
            **{k: rec[k] for k in ("replay_ms", "scratch_bytes", "events")
               if k in rec},
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": rec.get("library_ms")})
    return kernels


def match_list_case(dev, seed: int = 0, body: int = 60_000):
    """A hand-made match list in the v2 layout (pad row, window, body):
    a window tail of random bytes, then literals and matches laid out as a
    valid stream: runs (dist 1-3 < len), full-length matches of 258,
    matches reaching into the window tail up to 32768; padding entries
    (length 0) between matches and one all-padding row.  Returns (buffer
    with the literals placed, pos, meta) on `dev`."""
    from debigulator_tpu_torch.ops import lz77 as lz

    rng = np.random.default_rng(seed)
    origin = lz.BODY_START
    buf = np.zeros(((origin + body) // 128 + 8) * 128, np.int32)
    buf[lz.PAD : origin] = rng.integers(0, 256, lz.WINDOW)
    entries, cur = [], 0
    while cur < body - 300:
        if rng.random() < 0.4:
            n = int(rng.integers(1, 20))
            buf[origin + cur : origin + cur + n] = rng.integers(0, 256, n)
            cur += n
            continue
        kind = int(rng.integers(0, 4))
        ln = 258 if kind == 0 else int(rng.integers(3, 40))
        if kind == 1:
            dist = int(rng.integers(1, 4))
        elif kind == 2:  # into the window tail while it is in reach
            dist = int(rng.integers(min(cur + 1, lz.WINDOW), lz.WINDOW + 1))
        else:
            dist = int(rng.integers(1, min(cur, lz.WINDOW) + 1)) if cur else 1
        entries.append((origin + cur, (ln << 16) | dist))
        if len(entries) % 7 == 0:
            entries.append((origin, 0))
        cur += ln
    pos = np.full((-(-len(entries) // 128) + 2) * 128, origin, np.int32)
    meta = np.zeros(len(pos), np.int32)
    at = [i + 128 * (i >= 128) for i in range(len(entries))]  # row 1 empty
    pos[at] = [e[0] for e in entries]
    meta[at] = [e[1] for e in entries]
    return tuple(torch.from_numpy(a.reshape(-1, 128)).to(dev)
                 for a in (buf, pos, meta))


#: Hand-made match lists that rewrite bytes, which DEFLATE never makes
#: (rows 8, 10e and 10f): (dst, len, dist) offset from the body start, and
#: the n_matches row 8 resolves (None: every entry).
REWRITE_LISTS = {
    "reader_between_writers": ([(1000, 20, 100), (2000, 20, 1000),
                                (1010, 20, 800), (3000, 20, 1990)], None),
    "write_after_read": ([(1000, 20, 500), (500, 20, 300)], None),
    "three_writers": ([(1000, 30, 200), (1010, 30, 400), (1005, 10, 700),
                       (2000, 40, 1000), (1200, 30, 195)], None),
    "dist0_len0": ([(1000, 20, 0), (1100, 0, 50), (1000, 10, 300),
                    (1300, 5, 0), (1400, 30, 400), (1410, 0, 0)], None),
    "overlap_258": ([(1000, 258, 3), (1100, 258, 1), (1400, 258, 258),
                     (1127, 40, 7), (2000, 258, 900)], None),
    "n_matches_8": ([(1000 + 37 * i, 30 + i, 25 + 11 * i)
                     for i in range(16)], 8),
}


def rewrite_list(dev, name: str, origin: int):
    """(buffer, pos, meta, n) of REWRITE_LISTS[name] on `dev`: a buffer of
    random bytes (numpy seed 0) whose body starts at `origin` (the pad row
    and the window, or the window alone, before it) and holds 40 rows;
    pos and meta (8, 128) int32, padded with length-0 entries."""
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 256, origin + 40 * 128).astype(np.int32)
    recs, n = REWRITE_LISTS[name]
    pos = np.full(8 * 128, origin, np.int32)
    meta = np.zeros(8 * 128, np.int32)
    for i, (d, ln, dist) in enumerate(recs):
        pos[i], meta[i] = origin + d, ln << 16 | dist
    return (*(torch.from_numpy(a.reshape(-1, 128)).to(dev)
              for a in (buf, pos, meta)), len(recs) if n is None else n)


def copy_match_np(out: np.ndarray, d: int, n: int, dist: int) -> None:
    """Match (d, n, dist) applied to the flat numpy buffer: byte d + i
    takes byte d - dist + i % dist (the sources must lie in the buffer)."""
    if dist <= 0 or n <= 0:
        return
    if d - dist < 0 or d + n > out.size:
        raise AssertionError("the serial walk takes matches inside the buffer")
    if dist >= n:
        out[d : d + n] = out[d - dist : d - dist + n]
    else:
        out[d : d + n] = np.resize(out[d - dist : d], n)


def serial_check(name, got, buf, pos, meta, n) -> int:
    """Matches 0..n-1 of (pos, meta) applied one at a time in numpy to a
    copy of `buf` (the in-order walk of the TPU kernels of rows 8, 10e and
    10f); raises unless `got` equals it, else returns 0."""
    out = buf.reshape(-1).cpu().numpy().copy()
    for p, m in zip(pos.reshape(-1)[:n].tolist(),
                    meta.reshape(-1)[:n].tolist()):
        copy_match_np(out, p, m >> 16, m & 0xFFFF)
    if not np.array_equal(got.reshape(-1).cpu().numpy(), out):
        raise AssertionError(f"{name} disagrees with the serial walk")
    return 0


def v14_rewrite_case(dev, name: str):
    """Row 10c's arguments on a dense list that the v14 compaction never
    makes, over random bytes (numpy seed 0 or 1), with no runs:
    * rewritten: one 8 KiB segment; a group marked clean (bit 31 on its
      first match) holding a match of distance 5 and length 40, a group
      that writes bytes 1010..1019 twice, groups reading them, a clean
      group whose two members write one byte range (the later wins), a
      clean group with a member of distance 0 over bytes another member
      writes, and a group reading both;
    * clean_across_segments: two 4 KiB segments whose record ranges split
      a clean group of 8 (slots 16..19 and 20..23), the second part
      reading what the first wrote."""
    from debigulator_tpu_torch.ops import lz77 as lz

    b = lz.BODY_START
    dst = np.zeros(16 * 128, np.int64)
    meta = np.zeros(16 * 128, np.int64)
    if name == "rewritten":
        rng = np.random.default_rng(0)
        init = rng.integers(0, 256, b + 8192 + 512)
        groups = [[(500, 30, 200, 1), (600, 40, 5, 0), (700, 20, 300, 0)],
                  [(1000, 20, 100, 0), (1010, 20, 800, 0), (1100, 30, 90, 0)],
                  [(1500, 30, 495, 1), (1600, 25, 595, 0)],
                  [(2000, 20, 990, 0)],
                  [(2500, 20, 700, 1), (2510, 20, 1500, 0)],
                  [(3010, 20, 900, 1), (3000, 40, 0, 0)],
                  [(3500, 40, 1000, 0), (3600, 40, 1100, 0)]]
        for g, grp in enumerate(groups):
            for j, (d, n, dist, clean) in enumerate(grp):
                dst[g * 8 + j] = d
                meta[g * 8 + j] = clean << 31 | n << 16 | dist
        lims = np.array([[0, 8 * len(groups), 0, 0, 0, 0, 0, 0]])
    else:
        seg = 4096
        rng = np.random.default_rng(1)
        init = rng.integers(0, 256, b + 2 * seg + 512)
        for q in range(16):
            dst[q], meta[q] = 200 * q + 50, 20 << 16 | (30 + q)
        recs = {16: (3000, 20, 2000), 17: (3100, 30, 2500),
                18: (3200, 10, 100), 19: (3300, 40, 1200),
                20: (seg + 100, 30, seg + 100 - 3105),
                21: (seg + 300, 30, seg + 300 - 3000),
                22: (seg + 500, 20, 7), 23: (seg + 600, 40, 0)}
        for q, (d, n, dist) in recs.items():
            dst[q], meta[q] = d, n << 16 | dist
        meta[16] |= 1 << 31
        lims = np.array([[0, 20, 0, 0, 0, 0, 0, 0],
                         [20, 24, 0, 0, seg, 0, 0, 0]])
    t = [torch.from_numpy(a.astype(np.uint32).astype(np.int32).reshape(-1, 128))
         .to(dev) for a in (init, dst, meta)]
    z = torch.zeros((16, 128), dtype=torch.int32, device=dev)
    return (t[0], torch.from_numpy(lims.astype(np.int32)).to(dev), t[1], t[2],
            z, z, torch.zeros((8, 128), dtype=torch.int32, device=dev))


def serial_v14_check(name, got, buf, lims, mdst, mmeta, rdst, rmeta,
                     lit) -> int:
    """The v14 walk in numpy, one segment of `lims` after another as the
    TPU kernel's calls go: the runs, then each segment's matches in
    groups of 8 aligned to the dense index, a group whose first slot has
    bit 31 set loading all its members before it stores them (no wrap),
    any other match one at a time (distance 0 doing nothing); matches
    clipped to the body and cut at 512 - (dst & 127).  Raises unless `got`
    equals it, else returns 0."""
    from debigulator_tpu_torch.ops import lz77 as lz

    out = buf.reshape(-1).cpu().numpy().copy()
    rows = lims.reshape(-1, 8).cpu().numpy().astype(np.int64)
    body_end = (buf.shape[0] - lz.SLACK_ROWS) * 128
    adj = lz.BODY_START - int(rows[0, 4])
    rd, md = rdst.reshape(-1).cpu().numpy(), mdst.reshape(-1).cpu().numpy()
    rm = rmeta.reshape(-1).cpu().numpy().view(np.uint32)
    mm = mmeta.reshape(-1).cpu().numpy()
    fl = lit.reshape(-1).cpu().numpy()
    for i in range(int(rows[0, 2]), int(rows[-1, 3])):
        ln, lf = int(rm[i] & 0x7F), int(rm[i] >> 7)
        d = int(rd[i]) + adj
        for j in range(ln):
            if lz.BODY_START <= d + j < body_end and lf + j < fl.size:
                out[d + j] = fl[lf + j]
    for m_lo, m_hi in rows[:, :2].tolist():
        for g0 in range(m_lo & ~7, m_hi, 8):
            pieces = []
            for q in range(max(g0, m_lo), min(g0 + 8, m_hi)):
                m = int(mm[q])
                d = int(md[q]) + adj
                delta = max(lz.BODY_START - d, 0)
                eff = max(((m >> 16) & 0x1FF) - delta, 0)
                d += delta
                eff = min(eff, max(body_end - d, 0), 512 - (d & 127))
                pieces.append((d, eff, m & 0xFFFF))
            if mm[g0] < 0:
                loads = [out[d - dist : d - dist + n].copy()
                         for d, n, dist in pieces]
                for (d, n, _), v in zip(pieces, loads):
                    out[d : d + n] = v
            else:
                for d, n, dist in pieces:
                    copy_match_np(out, d, n, dist)
    if not np.array_equal(got.reshape(-1).cpu().numpy(), out):
        raise AssertionError(f"{name} disagrees with the serial walk")
    return 0


def group_case(dev, version: str, shape: str, seed: int = 0):
    """A hand-made piece list for the group resolvers (rows 10g, 10h and
    10a) that the packer never makes, over one 512 KiB segment of random
    bytes, as the wrapper of `version` ("v9", "v10", "v11") takes it:
    * clashing: 16,384 groups of 8 random pieces reading up to 700 bytes
      back, distance 0 included, so pieces read what their own group and
      later groups write and bytes are written many times;
    * two_writer: 8,192 pairs of groups, the first writing one byte range
      twice (two pieces, two sources, the later slot wins), the second
      reading it;
    * many_writer: 4,096 pieces (512 groups) over one 128-byte row, a
      third of them reading their own bytes (distance 0), then 511 pieces
      copying the row into the rows after it.
    Every piece stays inside its 128-byte row (v11's words need it); v10
    and v11 also get 2,048 disjoint literal pieces.  Returns the
    wrapper's arguments on `dev`."""
    from debigulator_tpu_torch.ops import lz77 as lz
    from debigulator_tpu_torch.parallel.merged import _pad_rec_rows

    rng = np.random.default_rng(seed)
    seg = 1 << 19
    b = lz.BODY_START
    n_out = b + seg + lz.SLACK_ROWS * 128

    def inside(d):  # lengths that keep each piece inside its row
        return rng.integers(1, 128 - (d & 127) + 1)

    if shape == "clashing":
        dst = b + rng.integers(0, seg - 128, 16_384 * 8)
        ln = inside(dst)
        src = dst - rng.integers(0, 700, dst.size)
    elif shape == "two_writer":
        n = 8192
        d0 = b + 1024 + rng.integers(0, seg - 2048, n) // 128 * 128
        d1 = d0 + rng.integers(0, 64, n)
        reader = (d0 + 128 + rng.integers(0, 60_000, n)) // 128 * 128
        reader = np.minimum(reader, b + seg - 128)
        pieces = np.zeros((n, 16, 3), np.int64)  # two groups a pair
        pieces[:, 0] = np.stack([d0, np.full(n, 96), d0 - rng.integers(
            1, 1000, n)], 1)
        pieces[:, 1] = np.stack([d1, 128 - (d1 & 127), d1 - rng.integers(
            1, 1000, n)], 1)
        pieces[:, 8] = np.stack([reader, np.full(n, 128), d0], 1)
        pieces = pieces.reshape(-1, 3)
        dst, ln, src = pieces[:, 0], pieces[:, 1], pieces[:, 2]
        dst = np.where(ln > 0, dst, b)
    else:
        row = b + 4096
        d = row + rng.integers(0, 64, 4096)
        n = inside(d - row)
        s = d - np.where(np.arange(4096) % 3 == 0, 0,
                         rng.integers(1, 900, 4096))
        cp = row + 128 * np.arange(1, 512)
        dst = np.concatenate([d, cp, [b]])
        ln = np.concatenate([n, np.full(511, 128), [0]])
        src = np.concatenate([s, np.full(511, row), [b]])
    ln = np.asarray(ln, np.int64)
    if version == "v11":
        rp = dst & 127
        q = src - rp
        gpos = ((dst >> 7) << 16) | (rp << 8) | (rp + ln)
        gmeta = ((q >> 7) << 16) | ((q & 127) << 8) | (128 - (q & 127))
        gpos = np.where(ln > 0, gpos, 0)
    else:
        gpos = dst - b
        gmeta = ln << 16 | (dst - src)
    init = rng.integers(0, 256, n_out).astype(np.int32)
    n_slots = gpos.size
    lims = np.array([0, n_slots, 0, 0, 0, 0, 0, 0], np.int64)
    t = [torch.from_numpy(_pad_rec_rows(a.astype(np.int32), 16)).to(dev)
         for a in (gpos, gmeta)]
    args = [torch.from_numpy(init.reshape(-1, 128)).to(dev), None, *t]
    if version != "v9":
        ld = b + 256 * np.arange(2048) + rng.integers(0, 64, 2048)
        lln = inside(ld)
        rel = 128 + np.concatenate([[0], np.cumsum(lln)[:-1]]) % (seg - 256)
        if version == "v11":
            rp = ld & 127
            lp = ((ld >> 7) << 16) | (rp << 8) | (rp + lln)
            q = rel - rp
            lm = ((q >> 7) << 16) | ((q & 127) << 8) | (128 - (q & 127))
        else:
            lp, lm = ld - b, lln << 20 | rel
        lims[3:6] = [0, 2048, 1]
        lit = rng.integers(0, 256, (seg // 128 + 16, 128)).astype(np.int32)
        args += [torch.from_numpy(_pad_rec_rows(a.astype(np.int32), 16))
                 .to(dev) for a in (lp, lm)]
        args.append(torch.from_numpy(lit).to(dev))
    args[1] = torch.from_numpy(lims.astype(np.int32)).to(dev)
    return tuple(args)


#: The group rows' chase: group_chase.cuh, over chase.cuh's chase loop.
GROUP_CHASE_VIA = ["debigulator_tpu_torch/csrc/group_chase.cuh",
                   "debigulator_tpu_torch/csrc/chase.cuh"]


def group_shape_record(dev, version: str, shape: str, fn, plain) -> dict:
    """One group resolver on group_case(dev, version, shape): exact
    against its plain twin (raises otherwise), its ms, plain ms and
    scratch bytes."""
    args = group_case(dev, version, shape)
    got = fn(*args)
    torch.cuda.synchronize()
    err = same(f"groups_{version} {shape}", (got,), (plain(*args),))
    del got
    gmeta = args[3].view(-1).long()
    live = (((gmeta >> 16) > 0) if version != "v11" else
            ((args[2].view(-1).long() & 255)
             - ((args[2].view(-1).long() >> 8) & 127) > 0))
    return {"shape": shape, "slots": args[2].numel(),
            "pieces": int(live.sum()), "max_abs_err": err,
            "ms": time_ms(lambda: fn(*args), 3),
            "plain_ms": time_ms(lambda: plain(*args), 1),
            "scratch_bytes": group_scratch_bytes(args[0].numel(),
                                                 args[2].numel())}


def event_stats(mb, w0, n_out: int) -> dict:
    """What the piece list asks of the event chase: its events (written
    words), the words written and their writers, mean and most."""
    from debigulator_tpu_torch.ops.phase_b import _expand

    a = w0.reshape(-1)[:mb._walked(w0, mb.STAGE_ROWS)].long()
    first = ((a >> 16) * 128 + ((a >> 8) & 127)).clamp(min=0)
    rec, off = _expand(mb.piece_events(w0, n_out))
    writers = torch.bincount(first[rec] + off, minlength=n_out)
    written = int((writers > 0).sum())
    return {"events": int(writers.sum()), "words_written": written,
            "writers_mean": int(writers.sum()) / max(written, 1),
            "writers_max": int(writers.max())}


def archive_kernel_phases(dev, base, streams):
    """The fifth slice: the v1/v2 match-list resolvers, the v9/v10 group
    resolvers (also on the walk's shapes of `base` and on group_case's
    lists) and the piece-loop microbenchmark against their plain versions,
    the microbenchmark tool's run, then archive_paths_2: v1 and v2 on one
    stream's token tape, v9 and the v10 kernel on the streams through the
    record scan and build_group_arrays_v10.  Returns the five kernels'
    entries for the `kernels` line."""
    import contextlib
    import io

    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.ops import lz77 as lz
    from debigulator_tpu_torch.ops import plan as tp
    from debigulator_tpu_torch.ops.archive import host_fed as hf
    from debigulator_tpu_torch.ops.archive import inflate_generations as ig
    from debigulator_tpu_torch.ops.archive import lz77_generations as lg
    from debigulator_tpu_torch.parallel.merged import build_merged_plan
    from debigulator_tpu_torch.tools import microbench_pb as mb
    from debigulator_tpu_torch.tools import profile_merged as pm

    counted = {"match_v1": lg.resolve_matches,
               "match_v2": lg.resolve_matches_v2,
               "groups_v9": lg.resolve_groups_v9,
               "groups_v10": lg.resolve_groups_v10,
               "microbench_pb": mb.microbench}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counted.items()}

    datas = [zlib.decompress(s, -15) for s in streams]
    vs = {n: [] for n in counted}
    timed = {}

    # --- rows 10e and 10f: a hand-made list, then one stream's tape ------
    lists = {"match_v1": (lg.resolve_matches, lg.resolve_matches_plain,
                          lz.WINDOW),
             "match_v2": (lg.resolve_matches_v2, lg.resolve_matches_v2_plain,
                          lz.BODY_START)}

    def layout(name, buf, pos, meta):
        """v2 inputs as they are, or in v1's layout: no pad row, positions
        less PAD."""
        if name == "match_v2":
            return buf, pos, meta
        return buf[lz.PAD // 128 :], pos - lz.PAD, meta

    # Each list against the plain twin and the serial walk: the hand-made
    # list, the lists that rewrite bytes (REWRITE_LISTS), one stream's.
    hand = match_list_case(dev)
    for name, (fn, plain, origin) in lists.items():
        a = layout(name, *hand)
        got = fn(*a)
        vs[name].append({"shape": "hand-made", "entries": a[1].numel(),
                         "max_abs_err": same(f"{name} hand-made", (got,),
                                             (plain(*a),)),
                         "serial_err": serial_check(f"{name} hand-made", got,
                                                    *a, a[1].numel())})
        for shape in REWRITE_LISTS:
            a = rewrite_list(dev, shape, origin)[:3]
            got = fn(*a)
            vs[name].append({
                "shape": shape, "entries": a[1].numel(),
                "max_abs_err": same(f"{name} {shape}", (got,), (plain(*a),)),
                "serial_err": serial_check(f"{name} {shape}", got, *a,
                                           a[1].numel())})
    one = build_merged_plan(streams[:1])
    arrays1 = tp.plan_arrays_v3(one.plan, dev)
    out_size = one.plan.out_size
    out_rows = inf._round_pow2(
        -(-(out_size + lz.BODY_START + lz.MAXLEN + 512) // 128), 64)
    m_rows = inf._round_pow2(-(-(out_size // 3 + 130) // 128), 16)
    tail = torch.zeros(lz.WINDOW, dtype=torch.int32, device=dev)

    def tape_args():
        tape, overflow, _, _ = inf.tape_v3(arrays1, one.plan.n_bits,
                                           one.plan.slots, exact=True)
        if bool(overflow):
            raise AssertionError("tape_v3 overflowed the exact slots")
        return (tape, arrays1["cell_block"], arrays1["block_out_base"],
                out_rows, m_rows, arrays1["stored_pos"],
                arrays1["stored_val"], tail)

    def decoded(out2d, origin, n=out_size):
        return out2d.view(-1)[origin : origin + n].to(torch.uint8).cpu() \
            .numpy().tobytes()

    out_init, pos1, meta1, n1 = inf.match_v4_inputs(*tape_args())
    for name, (fn, plain, origin) in lists.items():
        a = layout(name, out_init, pos1, meta1)
        got = fn(*a)
        torch.cuda.synchronize()
        rec = {"shape": "path", "entries": pos1.numel(), "matches": int(n1),
               "max_abs_err": same(name, (got,), (plain(*a),)),
               "serial_err": serial_check(name, got, *a, a[1].numel())}
        if decoded(got, origin) != datas[0]:
            raise AssertionError(f"{name}: decode is not bit-exact")
        rec["ms"] = time_ms(lambda: fn(*a), 3)
        # Nothing is read back in a call: its device time alone.
        rec["replay_ms"] = replay_ms(lambda: fn(*a))
        rec["plain_ms"] = time_ms(lambda: plain(*a), 1)
        rec["scratch_bytes"] = group_scratch_bytes(a[0].numel(), a[1].numel(),
                                                   lz.MATCH_PIECE)
        # The window and body read and written once; the meta of every
        # entry (the walk has no n_matches bound), the position of each
        # live match.
        rec["bytes"] = 4 * (2 * (origin + out_size) + pos1.numel() + int(n1))
        timed[name] = rec
        vs[name].append(rec)
    del out_init, pos1, meta1, got

    # --- rows 10g and 10h: a 512 KiB segment, then the streams -----------
    seg = tp.SEG_BYTES
    groups = {"groups_v9": (lg.resolve_groups_v9, lg.resolve_groups_v9_plain),
              "groups_v10": (lg.resolve_groups_v10,
                             lg.resolve_groups_v10_plain)}

    def group_inputs(batch):
        mp = build_merged_plan(batch, records=True)
        n_seg = inf.n_segments(mp.plan.out_size)
        arrays = hf.build_group_arrays_v10(mp.recs, n_seg, device=dev)
        runs = hf.literal_runs(mp.recs, device=dev)
        stored = (torch.from_numpy(np.asarray(mp.plan.stored_pos,
                                              np.int32)).to(dev),
                  torch.from_numpy(np.asarray(mp.plan.stored_val,
                                              np.uint8)).to(dev))
        return mp, n_seg, arrays, runs, stored

    for label, k in (("small", 2), ("path", len(streams))):
        mp, n_seg, arrays, runs, stored = group_inputs(streams[:k])
        seen = {}
        real9 = spy(lg, "resolve_groups_v9", seen)
        real10 = spy(lg, "resolve_groups_v10", seen)
        try:
            ig.inflate_v9(runs, arrays, *stored, n_seg)
            ig.inflate_v10_wide(arrays, *stored, n_seg)
        finally:
            lg.resolve_groups_v9, lg.resolve_groups_v10 = real9, real10
        flat = np.frombuffer(b"".join(datas[:k]), np.uint8)
        for name, (fn, plain) in groups.items():
            a = seen[f"resolve_{name}"][-1][0]
            got = fn(*a)
            torch.cuda.synchronize()
            rec = {"shape": label, "streams": k, "n_seg": n_seg,
                   "max_abs_err": same(name, (got,), (plain(*a),))}
            pm.check(got.view(-1)[lz.BODY_START:], mp, datas[:k])
            if label == "path":
                rec["ms"] = time_ms(lambda: fn(*a), 3)
                # Nothing is read back in a call: its device time alone.
                rec["replay_ms"] = replay_ms(lambda: fn(*a))
                rec["plain_ms"] = time_ms(lambda: plain(*a), 1)
                rec["scratch_bytes"] = group_scratch_bytes(a[0].numel(),
                                                           a[2].numel())
                lims = a[1]
                n_pieces = int(((a[3].view(-1).long() >> 16) > 0).sum())
                rec["pieces"] = n_pieces
                # The window and bodies read and written once, two words a
                # live piece, the limits; for v10 two words a literal piece
                # and the literal bytes.
                b = 2 * (lz.BODY_START + len(flat)) + 2 * n_pieces \
                    + lims.numel()
                if name == "groups_v10":
                    rec["literal_pieces"] = int((lims[:, 4] - lims[:, 3]).sum())
                    b += 2 * rec["literal_pieces"] + len(mp.recs["lit"])
                rec["bytes"] = 4 * b
                timed[name] = rec
            else:
                # Segment 1 alone, the reference's kernel-call shape: its
                # window the bytes before it, its body as the driver placed
                # it (literal runs and stored bytes for v9, stored bytes for
                # v10).
                body = a[0].view(-1)[lz.BODY_START + seg : lz.BODY_START + 2 * seg]
                call = (window_buffer(flat, seg, body, dev),
                        a[1][1].contiguous(), *a[2:])
                got1 = fn(*call)
                torch.cuda.synchronize()
                err = same(f"{name} segment", (got1,), (plain(*call),))
                n = min(seg, len(flat) - seg)
                if decoded(got1, lz.BODY_START, n) != flat[seg : seg + n].tobytes():
                    raise AssertionError(f"{name}: segment is not bit-exact")
                vs[name].append({"shape": "segment 1", "seg_off": seg,
                                 "max_abs_err": err})
            vs[name].append(rec)
        del seen, got, arrays, runs

    # The walk's adversarial shapes (as rows 10a and 10c run them), then
    # the hand-made lists that break the packer's rules (group_case).
    for shape, (strms, dts) in walk_case_streams(base).items():
        mp, n_seg, arrays, runs, stored = group_inputs(strms)
        seen = {}
        real9 = spy(lg, "resolve_groups_v9", seen)
        real10 = spy(lg, "resolve_groups_v10", seen)
        try:
            ig.inflate_v9(runs, arrays, *stored, n_seg)
            ig.inflate_v10_wide(arrays, *stored, n_seg)
        finally:
            lg.resolve_groups_v9, lg.resolve_groups_v10 = real9, real10
        for name, (fn, plain) in groups.items():
            a = seen[f"resolve_{name}"][-1][0]
            got = fn(*a)
            torch.cuda.synchronize()
            err = same(f"{name} at {shape}", (got,), (plain(*a),))
            pm.check(got.view(-1)[lz.BODY_START:], mp, dts)
            vs[name].append({
                "shape": shape, "streams": len(strms),
                "out_bytes": mp.plan.out_size, "max_abs_err": err,
                "ms": time_ms(lambda: fn(*a), 3),
                "replay_ms": replay_ms(lambda: fn(*a)),
                "plain_ms": time_ms(lambda: plain(*a), 1),
                "scratch_bytes": group_scratch_bytes(a[0].numel(),
                                                     a[2].numel())})
            del got
        del seen, arrays, runs
    for name, (fn, plain) in groups.items():
        for shape in GROUP_SHAPES:
            vs[name].append(group_shape_record(dev, name.split("_")[1],
                                               shape, fn, plain))

    # --- row 11: the piece loop, every variant against the plain one -----
    # Checked on a buffer of random bytes, so that a wrong source, order or
    # mask shows (on zeros every copy leaves zeros); the tool's zero buffer
    # is for timing only.  full and unrollN run the event chase, the
    # probes the staged loop; the chase also on the hand-made clashing
    # list and at the tool's 2^21 pieces.
    rand = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (mb.ROWS, 128)).astype(np.int32)).to(dev)
    idle = ("noop", "noop8", "scalar_smem")  # they store nothing

    def mb_check(v, w0, w1, buf=rand):
        want = mb.microbench_plain(v, w0, w1, buf)
        if v not in idle and bool(torch.equal(want, buf)):
            raise AssertionError(f"microbench {v}: the plain version "
                                 "leaves the check's buffer as it was")
        return same(f"microbench {v}", (mb.microbench(v, w0, w1, buf),),
                    (want,))

    n_red = 1 << 16
    w0, w1 = (torch.from_numpy(w).to(dev) for w in mb.make_pieces(n_red))
    errs = {v: mb_check(v, w0, w1) for v in mb.VARIANTS if v != "nodma"}
    vs["microbench_pb"].append({"shape": "reduced", "pieces": n_red,
                                "max_abs_err": errs})
    w0, w1, init = (torch.from_numpy(x).to(dev) for x in mb.clash_pieces())
    vs["microbench_pb"].append({
        "shape": "clash", "pieces": w0.numel(),
        **event_stats(mb, w0, init.numel()),
        "max_abs_err": {v: mb_check(v, w0, w1, init) for v in mb.CHASE}})
    w0, w1 = (torch.from_numpy(w).to(dev) for w in mb.make_pieces())
    rec = {"shape": "path", "pieces": mb.N_PIECES,
           "max_abs_err": {v: mb_check(v, w0, w1) for v in mb.CHASE}}
    init = torch.zeros((mb.ROWS, 128), dtype=torch.int32, device=dev)
    rec["ms"] = mb.run_variant("full", w0, w1, init)
    plan = mb._plan("full", w0, w1, init.numel(), mb.STAGE_ROWS)
    out = init.clone()

    def chase():
        mb._launch("full", w0, w1, out, mb.STAGE_ROWS, plan)

    rec["replay_ms"] = replay_ms(chase)
    rec["parts"] = device_parts(chase)
    # ms a launch of each pass: the profiler may lose records here, after
    # the earlier phases' profiling (launches a call below the call's own).
    rec["pass_ms"] = {
        name.replace("(anonymous namespace)::", "").removeprefix("void ")
        .split("(")[0].strip(): ms / n for name, ms, n in rec["parts"] if n}
    rec.update(event_stats(mb, w0, init.numel()))
    if rec["events"] != plan[1]:
        raise AssertionError("microbench: the wrapper's event count "
                             f"{plan[1]} is not the list's {rec['events']}")
    rec["scratch_bytes"] = mb.chase_scratch_bytes(init.numel(),
                                                  plan[0].numel(), plan[1])
    rec["plain_ms"] = time_ms(lambda: mb.microbench_plain("full", w0, w1,
                                                          init), 1)
    # Two words a piece read once, the buffer read and written once.
    rec["bytes"] = 4 * (2 * mb.N_PIECES + 2 * init.numel())
    timed["microbench_pb"] = rec
    vs["microbench_pb"].append(rec)
    del plan, out
    del w0, w1, rand
    for name, shp in vs.items():
        emit({"phase": f"{name}_vs_plain", "max_abs_err": 0, "shapes": shp})

    # The tool's own run is the microbenchmark's path.
    reset()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        mb.main()
    torch.cuda.synchronize()
    dmb = counts()
    require_launches("microbench_pb", dmb, ("microbench_pb",))
    emit({"phase": "microbench_pb", "pieces": mb.N_PIECES,
          "lines": text.getvalue().splitlines(), "launches": dmb})

    # --- archive_paths_2: v2 and v1 on one stream, v9 and v10 on all ------
    # Each path is driven once with the counts set to 0 just before it and
    # read just after; timing repeats come after the read.
    paths, launches = {}, dict(dmb)
    for name, driver in (("match_v2", ig.resolve_tape_matches_v2),
                         ("match_v1", ig.resolve_tape_matches_v1)):
        reset()
        t0 = time.perf_counter()
        got = driver(*tape_args())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = counts()
        if decoded(got, lists[name][2]) != datas[0]:
            raise AssertionError(f"{name} path: decode is not bit-exact")
        require_launches(f"archive_paths_2, {name}", d, (name,))
        paths[name] = {"out_bytes": out_size, "tape_v3_and_resolve_ms": ms,
                       "launches": d}
        launches = {k: launches[k] + d[k] for k in counted}

    t0 = time.perf_counter()
    mp, n_seg, arrays, runs, stored = group_inputs(streams)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    for name, run in (
            ("groups_v9", lambda: ig.inflate_v9(runs, arrays, *stored, n_seg)),
            ("groups_v10", lambda: ig.inflate_v10_wide(arrays, *stored,
                                                       n_seg))):
        reset()
        body = run()
        torch.cuda.synchronize()
        d = counts()
        pm.check(body, mp, datas)
        require_launches(f"archive_paths_2, {name}", d, (name,))
        paths[name] = {"device_ms": host_ms(
            lambda: (run(), torch.cuda.synchronize())), "launches": d}
        launches = {k: launches[k] + d[k] for k in counted}
    paths["host_scan_and_prep_ms"] = prep_ms
    emit({"phase": "archive_paths_2", "streams": len(streams),
          "out_bytes": sum(map(len, datas)), "bit_exact": True, **paths,
          "launches": launches})

    sources = {
        "match_v1": ("debigulator_tpu_torch/csrc/lz77_match.cu",
                     "debigulator_tpu/ops/archive/lz77_generations.py:171"),
        "match_v2": ("debigulator_tpu_torch/csrc/lz77_match.cu",
                     "debigulator_tpu/ops/archive/lz77_generations.py:231"),
        "groups_v9": ("debigulator_tpu_torch/csrc/groups_v9.cu",
                      "debigulator_tpu/ops/archive/lz77_generations.py:345"),
        "groups_v10": ("debigulator_tpu_torch/csrc/groups_v9.cu",
                       "debigulator_tpu/ops/archive/lz77_generations.py:431"),
        "microbench_pb": ("debigulator_tpu_torch/csrc/microbench_pb.cu",
                          "tools/microbench_pb.py:31"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        rec = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            **({"via": GROUP_CHASE_VIA} if name != "microbench_pb" else {}),
            "launches": launches[name], "max_abs_err": 0, "ms": rec["ms"],
            **{k: rec[k] for k in ("replay_ms", "scratch_bytes", "events")
               if k in rec},
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None})
    return kernels


def rotations(base: bytes, k: int) -> bytes:
    """The k rotations that make_streams compresses, one after another (the
    29 at BASE_BYTES are 16,294,288 bytes)."""
    return b"".join(base[r:] + base[:r]
                    for r in ((i * 40961) % len(base) for i in range(k)))


def split_walk_bytes(plan: dict, body_len: int, patch: bool) -> int:
    """What one walk of a split shard must move, walk_work's way, at 4
    bytes per int32 element: its run records (2 words) and literals, its
    match records (2 words), and the bytes it writes, once each.  Phase 1
    writes the shard's body (not the window prologue, which no record
    writes); a patch round writes only its tainted matches' bytes (their
    lengths, mmeta >> 16).  Match sources are not charged."""
    lits = int((plan["rmeta"] & 0x7F).sum())
    written = (int((plan["mmeta"] >> 16).astype(np.int64).sum()) if patch
               else body_len)
    return 4 * (2 * len(plan["rdst"]) + lits + 2 * len(plan["mdst"])
                + written)


def split_walk_vs_plain(name, staged, p1_outs) -> list:
    """Row 3 against its plain version on shard 1 of a split plan: its
    phase-1 list, and its first patch round with shard 0's phase-1 tail
    as the window and its own phase-1 output as the body."""
    from debigulator_tpu_torch.ops import phase_b as pb

    p1, pp = staged[1]
    rows = []
    for kind, plan, buf in (
            ("phase1", p1, pb.records_buffer(p1)),
            ("patch", pp, pb.records_buffer(pp, tail0=p1_outs[0][-pb.WINDOW:],
                                            body_init=p1_outs[1]))):
        lists = (plan["mdst"], plan["mmeta"], plan["rdst"], plan["rmeta"],
                 plan["lit"])
        got = pb.walk(buf.clone(), *lists)
        torch.cuda.synchronize()
        err = same(f"walk on {name} shard 1 {kind}", (got,),
                   (pb.walk_plain(buf.clone(), *lists),))
        out = got.clone()
        host = {k: plan[k].cpu().numpy()
                for k in ("mdst", "mmeta", "rdst", "rmeta")}
        n_bytes = split_walk_bytes(host, buf.numel() - pb.WINDOW,
                                   kind == "patch")
        rows.append({
            "shape": f"{name}_shard1_{kind}", "matches": len(host["mdst"]),
            "runs": len(host["rdst"]), "out_len": buf.numel(),
            "max_abs_err": err,
            "ms": time_ms(lambda: pb.walk(out, *lists), 5),
            "plain_ms": time_ms(lambda: pb.walk_plain(buf.clone(), *lists), 1),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": n_bytes})
        if not torch.equal(out, got):
            raise AssertionError(f"repeated walk on {name} changed its output")
    return rows


def parallel_phases(dev, base: bytes, streams: list[bytes], corpus,
                    cards=None):
    """The thirteenth slice: the split-stream decode of one stream over
    four shards (the 29 rotations as one 16,294,288-byte stream, and a 4
    MiB b"ab" run whose taint reaches every tail) through a 4-entry sp
    mesh of ``cards`` (``[dev]`` by default; the shards take the cards in
    turn); the batch layer on the 29 streams (on ``dev``, and over a mesh
    of ``cards``) and on the PNG corpus (make_corpus(0)) through
    decode_png_batch(mesh=make_mesh()).  Every output exact.  Then the
    split path's parts: host plan, phase 1 and each round by CUDA events,
    and row 3 against its plain version on the split shapes.  Returns the
    phase's line and extra fields of the `kernels` entries."""
    from debigulator_tpu_torch.models import pipeline as pl
    from debigulator_tpu_torch.ops import phase_b as pb
    from debigulator_tpu_torch.ops import unfilter as uf
    from debigulator_tpu_torch.parallel import batch
    from debigulator_tpu_torch.parallel import split_stream as ss
    from debigulator_tpu_torch.parallel.mesh import make_mesh

    n = 4
    text = rotations(base, len(streams))
    rle = b"ab" * (1 << 21)
    cases = {}
    for name, data in (("text", text), ("rle", rle)):
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        cases[name] = (c.compress(data) + c.flush(), data)
    cards = cards or [dev]
    sp_mesh = make_mesh(dp=1, sp=n,
                        devices=[cards[i % len(cards)] for i in range(n)])

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        return out, (time.perf_counter() - t0) * 1e3

    # --- the path, driven once between a reset and a read of the counts --
    pb.walk.launches = uf.unfilter.launches = 0
    split = {}
    for name, (stream, data) in cases.items():
        w0 = pb.walk.launches
        got, e2e = timed(lambda: ss.decode_split_stream(stream, mesh=sp_mesh))
        if got != data:
            raise AssertionError(f"split decode of {name} is not bit-exact")
        split[name] = {"out_bytes": len(data), "compressed_bytes": len(stream),
                       "e2e_ms": e2e, "walk_launches": pb.walk.launches - w0}
    want = [zlib.decompress(s, -15) for s in streams]
    outs, batch_ms = timed(lambda: batch.decode_batch_device(streams,
                                                             device=dev))
    if outs != want:
        raise AssertionError("batch decode is not bit-exact")
    outs, batch_mesh_ms = timed(lambda: batch.decode_batch_device(
        streams, mesh=make_mesh(devices=cards)))
    if outs != want:
        raise AssertionError("batch decode over a mesh is not bit-exact")
    imgs, png_ms = timed(lambda: pl.decode_png_batch(
        [c[1] for c in corpus], mesh=make_mesh(), device=dev))
    for img, c in zip(imgs, corpus, strict=True):
        if not np.array_equal(img, c[2]):
            raise AssertionError(f"decode_png_batch(mesh=) differs at {c[0]}")
    launches = {"walk": pb.walk.launches, "unfilter": uf.unfilter.launches}
    require_launches("parallel_paths", launches, launches)
    n_images = len(imgs)
    del outs, imgs, corpus
    torch.cuda.empty_cache()

    # --- the split path's parts, and row 3 on its shapes -----------------
    shapes = []
    for name, (stream, data) in cases.items():
        plan = ss.plan_split_stream(stream, n)
        staged = ss.stage_split(plan, [dev] * n)
        p1 = ss.phase1(staged)
        outs = p1
        zero = torch.zeros(pb.WINDOW, dtype=torch.int32, device=dev)
        round_ms = []
        for _ in range(plan.rounds):
            tails = [zero] + [o[-pb.WINDOW:] for o in outs[:-1]]
            round_ms.append(time_ms(lambda: ss.patch_round(staged, outs,
                                                           tails), 3))
            outs = ss.patch_round(staged, outs, tails)
        body = torch.cat(outs)[: plan.out_size].to(torch.uint8).cpu().numpy()
        if body.tobytes() != data:
            raise AssertionError(f"split rounds of {name} are not bit-exact")
        n_m = sum(len(p["mdst"]) for p in plan.phase1)
        n_t = sum(len(p["mdst"]) for p in plan.patch)
        split[name].update({
            "shard_bytes": plan.shard_bytes, "n_seg": plan.n_seg,
            "rounds": plan.rounds, "matches": n_m, "tainted_matches": n_t,
            "tainted_share": n_t / max(n_m, 1),
            "host_plan_ms": host_ms(lambda: ss.plan_split_stream(stream, n)),
            "stage_ms": host_ms(lambda: (ss.stage_split(plan, [dev] * n),
                                         torch.cuda.synchronize())),
            "phase1_ms": time_ms(lambda: ss.phase1(staged), 3),
            "round_ms": round_ms})
        shapes += split_walk_vs_plain(name, staged, p1)
        del plan, staged, p1, outs, body
    if split["rle"]["rounds"] != 3:
        raise AssertionError(f"the RLE run took {split['rle']['rounds']} "
                             "rounds, not 3")
    line = {"phase": "parallel_paths", "shards": n,
            "cards": [str(d) for d in cards], "split": split,
            "batch": {"streams": len(streams), "e2e_ms": batch_ms,
                      "mesh_e2e_ms": batch_mesh_ms},
            "png_batch_mesh": {"images": n_images, "e2e_ms": png_ms},
            "walk_vs_plain": shapes, "launches": launches}
    extra = {"walk": {"launches_parallel_paths": launches["walk"],
                      "split_shapes": shapes},
             "unfilter": {"launches_parallel_paths": launches["unfilter"]}}
    return line, extra


# ---------------------------------------------------------------------------
# The fifteenth slice: the front door (CLIs, host encoder) and multihost
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent
#: The port's kernels of the gzip path, as a profiler trace names them:
#: Phase A (its table, then the decode), compact, and the walk.
TRACE_KERNELS = {"phase_a": ("phase_a_kernel", "lut_kernel"),
                 "compact": ("compact_kernel",),
                 "walk": ("run_kernel", "pointer_kernel", "chase_kernel")}
#: The flagship's named scopes around those kernels.  On one 562 KB stream
#: each kernel runs 2-16 us, under the 100 us cut of the top-ops list, so
#: that list names the scopes; the CLI lists every kernel after it.
TRACE_SCOPES = ("phase_a_huffman", "phase_b_lz77", "v15_prep", "v15_compact",
                "v15_walk")
#: Side of the top-left crop of the encode path's image that encode_png
#: encodes with its default, the host encoder: the whole 1024 x 1024 image
#: took 190 s of host time on the card's machine.
HOST_PNG_SIDE = 512
#: Side of the crop that cuda_png encode and roundtrip take: the host
#: encoder and the serial Python inflate of roundtrip make a whole corpus
#: image minutes of host time.
CLI_CROP = 192


def run_cli(module: str, *args: str, timeout: float = 600.0) -> dict:
    """One CLI of the port as a subprocess from the checkout's root: its
    stderr, stdout and wall ms.  Raises when it exits non-zero."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", f"debigulator_tpu_torch.cli.{module}", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if r.returncode != 0:
        raise AssertionError(f"{module} {args[0]} exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    return {"err": r.stderr, "out": r.stdout, "wall_ms": wall_ms}


def first_steady(err: str) -> dict:
    """The first and steady ms a cuda_gz decode printed."""
    import re

    m = re.search(r"first ([\d.]+) ms, steady ([\d.]+) ms", err)
    return {"first_ms": float(m.group(1)), "steady_ms": float(m.group(2))}


def listed_rows(err: str, heading: str) -> list:
    """The rows a cuda_gz --trace printed under ``heading`` ("top ops:":
    [ms, name]; "device kernels:": [ms, launches, name])."""
    rows = []
    if heading not in err:
        return rows
    for line in err.split(heading + "\n", 1)[1].splitlines():
        if not line.startswith("  "):
            break
        ms, rest = line.split(" ms  ", 1)
        if heading == "device kernels:":
            n, name = rest.strip().split("x  ", 1)
            rows.append([float(ms), int(n), name])
        else:
            rows.append([float(ms), rest])
    return rows


def front_door_phase(dev, base: bytes, corpus) -> dict:
    """The CLIs as a user runs them, each a subprocess: cuda_gz decode
    (--repeat 3 --trace) of the OBJ text gzipped by the port's encode_gzip
    and by gzip, cuda_gz encode, cuda_png decode of the 16-image corpus
    (--bench), encode and roundtrip of a crop, cuda_bmp roundtrip and info;
    every output checked against zlib or the source pixels, and the trace
    shown to hold the port's Phase A, compact and walk kernels on the card.
    Before them, in this process on the card's host: the host encoder on
    the text (deflate, encode_gzip) and encode_png with its default (the
    host encoder) on a HOST_PNG_SIDE crop of the encode path's 1024x1024
    RGBA image, beside the device encoder on the same rows."""
    import tempfile

    from debigulator_tpu_torch.models import bmp_codec, png_codec
    from debigulator_tpu_torch.models import pipeline as pl
    from debigulator_tpu_torch.models.gzip_codec import encode_gzip
    from debigulator_tpu_torch.ops import deflate_encode as henc
    from debigulator_tpu_torch.ops import deflate_encode_device as enc
    from debigulator_tpu_torch.utils.preview import summary

    line = {"phase": "front_door"}
    # --- host encoder on the card's host ---------------------------------
    t0 = time.perf_counter()
    raw = henc.deflate(base)
    deflate_ms = (time.perf_counter() - t0) * 1e3
    if zlib.decompress(raw, -15) != base:
        raise AssertionError("host deflate does not decode to its input")
    t0 = time.perf_counter()
    gz_port = encode_gzip(base, fname=b"obj.txt")
    gzip_ms = (time.perf_counter() - t0) * 1e3
    if gzip.decompress(gz_port) != base:
        raise AssertionError("encode_gzip does not decode to its input")
    line["host_encoder"] = {
        "input_bytes": len(base), "deflate_ms": deflate_ms,
        "deflate_bytes": len(raw), "encode_gzip_ms": gzip_ms,
        "encode_gzip_bytes": len(gz_port),
        "zlib6_bytes": len(zlib.compress(base, 6)) - 6,
        "btype": (raw[0] >> 1) & 3}

    full = corpus[0][2]  # the encode path's 1024 x 1024 RGBA image
    src = np.ascontiguousarray(full[:HOST_PNG_SIDE, :HOST_PNG_SIDE])
    h, w, ch = src.shape
    t0 = time.perf_counter()
    png_host = png_codec.encode_png(src, device=dev)
    host_png_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(pl.decode_png_device(png_host, device=dev), src):
        raise AssertionError("encode_png's default output is not the image")

    def device_deflate(d):
        return enc.deflate_fixed_device(d, stride=1 + w * ch, device=dev)

    t0 = time.perf_counter()
    png_dev = png_codec.encode_png(src, deflate_fn=device_deflate, device=dev)
    dev_png_ms = (time.perf_counter() - t0) * 1e3
    line["encode_png"] = {
        "image": f"{w}x{h}x{ch}", "cut": f"top-left {w}x{h} of "
        f"{full.shape[1]}x{full.shape[0]}", "filtered_bytes": h * (1 + w * ch),
        "default_ms": host_png_ms, "default_bytes": len(png_host),
        "device_encoder_ms": dev_png_ms, "device_encoder_bytes": len(png_dev),
        "exact": True}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # --- cuda_gz -------------------------------------------------------
        (tmp / "obj.txt").write_bytes(base)
        gz_files = {"encode_gzip": gz_port, "gzip": gzip.compress(base, 6)}
        line["cuda_gz"] = {}
        for name, blob in gz_files.items():
            f, out, logdir = tmp / f"{name}.gz", tmp / f"{name}.out", \
                tmp / f"trace_{name}"
            f.write_bytes(blob)
            r = run_cli("cuda_gz", "decode", str(f), "-o", str(out),
                        "--repeat", "3", "--trace", str(logdir),
                        "--device", dev.type)
            if out.read_bytes() != base:
                raise AssertionError(f"cuda_gz decode of {name} is not exact")
            ops = listed_rows(r["err"], "top ops:")
            # Every kernel of the trace, ranked by device time.
            ranked = listed_rows(r["err"], "device kernels:")
            scopes = [sc for sc in TRACE_SCOPES if sc in {n for _, n in ops}]
            ours = {k: [[i + 1, n, ms] for i, (ms, n, kname)
                        in enumerate(ranked) if any(x in kname for x in names)]
                    for k, names in TRACE_KERNELS.items()}
            missing = [k for k, rows in ours.items() if not rows]
            if missing or not {"phase_a_huffman", "phase_b_lz77"} <= set(scopes):
                raise AssertionError(
                    f"cuda_gz --trace of {name} lists no kernel of {missing}, "
                    f"or the top ops miss the flagship's scopes ({scopes}): "
                    "the CLI did not run them on the card")
            line["cuda_gz"][name] = {
                "compressed_bytes": len(blob), **first_steady(r["err"]),
                "wall_ms": r["wall_ms"], "top_ops": ops,
                "scopes_listed": scopes, "kernels": ranked[:12],
                "trace_kernels": len(ranked),
                "trace_launches": sum(n for _, n, _ in ranked),
                "trace_kernel_ms": sum(ms for ms, _, _ in ranked),
                "ours": ours}  # [rank, launches, ms] of each
        r = run_cli("cuda_gz", "encode", str(tmp / "obj.txt"), "-o",
                    str(tmp / "enc.gz"))
        blob = (tmp / "enc.gz").read_bytes()
        if blob != gz_port or gzip.decompress(blob) != base:
            raise AssertionError("cuda_gz encode differs from encode_gzip")
        line["cuda_gz"]["encode"] = {"bytes": len(blob),
                                     "wall_ms": r["wall_ms"],
                                     "stderr": r["err"].strip()[-200:]}

        # --- cuda_png ------------------------------------------------------
        files = []
        for name, png, rgba, _, _ in corpus:
            files.append(tmp / f"{name}.png")
            files[-1].write_bytes(png)
        r = run_cli("cuda_png", "decode", *map(str, files), "--bench",
                    "--device", dev.type)
        lines = r["err"].strip().splitlines()
        for f, (_, _, rgba, _, _), got in zip(files, corpus, lines):
            if not got.startswith(f"{f}: {summary(rgba)} in "):
                raise AssertionError(f"cuda_png decode of {f.name}: {got}")
        if not lines[-1].startswith("total:"):
            raise AssertionError("cuda_png decode --bench printed no total")
        crop = np.ascontiguousarray(src[:CLI_CROP, :CLI_CROP])
        crop.tofile(tmp / "crop.raw")
        r2 = run_cli("cuda_png", "encode", str(tmp / "crop.raw"),
                     f"{CLI_CROP}x{CLI_CROP}", "-o", str(tmp / "crop.png"),
                     "--device", dev.type)
        crop_png = (tmp / "crop.png").read_bytes()
        if not np.array_equal(pl.decode_png_device(crop_png, device=dev), crop):
            raise AssertionError("cuda_png encode's file is not the crop")
        r3 = run_cli("cuda_png", "roundtrip", str(tmp / "crop.png"),
                     "--device", dev.type)
        if "RGBA-bit-exact" not in r3["err"]:
            raise AssertionError(f"cuda_png roundtrip: {r3['err']}")
        line["cuda_png"] = {
            "decode": {"images": len(files), "total": lines[-1],
                       "wall_ms": r["wall_ms"]},
            "encode": {"crop": f"{CLI_CROP}x{CLI_CROP} of "
                                f"{full.shape[1]}x{full.shape[0]}",
                       "png_bytes": len(crop_png), "wall_ms": r2["wall_ms"],
                       "stderr": r2["err"].strip()[-200:]},
            "roundtrip": {"wall_ms": r3["wall_ms"],
                          "stderr": r3["err"].strip()[-200:]}}

        # --- cuda_bmp ------------------------------------------------------
        bmp = bmp_codec.encode_bmp(full)
        (tmp / "img.bmp").write_bytes(bmp)
        r = run_cli("cuda_bmp", "roundtrip", str(tmp / "img.bmp"), "-o",
                    str(tmp / "out.bmp"))
        if (tmp / "out.bmp").read_bytes() != bmp or "bit-exact" not in r["err"]:
            raise AssertionError("cuda_bmp roundtrip is not exact")
        ri = run_cli("cuda_bmp", "info", str(tmp / "img.bmp"))
        if not ri["out"].strip().endswith(f"{full.shape[1]}x{full.shape[0]}"):
            raise AssertionError(f"cuda_bmp info: {ri['out']}")
        line["cuda_bmp"] = {"bytes": len(bmp), "wall_ms": r["wall_ms"],
                            "info_wall_ms": ri["wall_ms"]}
    line["exact"] = True
    return line


def multihost_phase(streams: list[bytes], procs: int,
                    device: str = "cuda") -> dict:
    """A world of ``procs`` processes over the streams on this machine's
    cards (rank r on cuda:{r % cards}; gloo carries the manifest), beside a
    world of one: every stream exact in its worker, the manifest complete
    and equal to zlib's sizes and CRC-32s, rows 1-3 launched in every
    worker, each worker's decode ms."""
    import tempfile

    from debigulator_tpu_torch.parallel import multihost as mh

    datas = [zlib.decompress(s, -15) for s in streams]
    want = [[1, len(d), zlib.crc32(d)] for d in datas]
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, s in enumerate(streams):
            files.append(str(Path(tmp) / f"s{i:02d}.deflate"))
            Path(files[-1]).write_bytes(s)
        t0 = time.perf_counter()
        single = mh.cluster(1, device, files)[0]
        single_wall = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        outs = mh.cluster(procs, device, files)
        world_wall = (time.perf_counter() - t0) * 1e3
    workers = []
    for rank, so in enumerate([single] + outs):
        launches = mh.worker_field(so, "LAUNCHES")
        if mh.worker_field(so, "MANIFEST") != want:
            raise AssertionError(f"worker {rank}: manifest differs from zlib")
        if not all(launches.get(k, 0) > 0
                   for k in ("phase_a", "compact", "walk")):
            raise AssertionError(f"worker {rank} launched no kernel of rows "
                                 f"1-3: {launches}")
        workers.append({"decode_ms": mh.decode_ms(so), "launches": launches})
    single_ms = workers[0]["decode_ms"]
    world_ms = max(wk["decode_ms"] for wk in workers[1:])
    return {"phase": "multihost", "world": procs,
            "cards": torch.cuda.device_count(), "backend": "gloo",
            "streams": len(streams), "out_bytes": sum(map(len, datas)),
            "exact": True, "manifest_complete": True,
            "single_decode_ms": single_ms, "single": workers[0],
            "workers": workers[1:], "world_decode_ms_max": world_ms,
            "ratio": single_ms / world_ms,
            "single_wall_ms": single_wall, "world_wall_ms": world_wall}


# ---------------------------------------------------------------------------
# The sixteenth slice: the profiling tools
# ---------------------------------------------------------------------------

#: sha256 of tools/inputs.k4_png()'s filtered scanlines (numpy makes them;
#: the PNG's bytes depend on the machine's zlib as well).
K4_SCANLINES_SHA256 = (
    "c338ac4d71f6514e2ab66bfd9bd974ba35e37039e78e84ec272275b1841db7a0")


def tools_phase(dev, streams: list[bytes], corpus) -> dict:
    """The five tools' functions in this process on the card at their
    defaults, each raising on any mismatch: its numbers, wall seconds and
    the launches of rows 1-5 and 9 it made (check_4k_unfilter also its
    stream's plan and one call taken apart by decode_breakdown); then
    trace_v15 --no-trace as a subprocess."""
    import hashlib
    import re

    from debigulator_tpu_torch.models import png_codec
    from debigulator_tpu_torch.ops import deflate_encode_device as denc
    from debigulator_tpu_torch.ops import lz77 as lz
    from debigulator_tpu_torch.ops import phase_a as pa
    from debigulator_tpu_torch.ops import phase_b as pb
    from debigulator_tpu_torch.ops import unfilter as uf
    from debigulator_tpu_torch.ops.plan import (
        CELL_BITS,
        build_plan_v3,
        v15_stream_too_large,
    )
    from debigulator_tpu_torch.ops.scanner import scan_stream_cells
    from debigulator_tpu_torch.tools import (
        check_4k_unfilter,
        inputs,
        profile_corpus,
        profile_encoder,
        profile_r3,
        trace_v15,
    )

    counted = {"phase_a": pa.phase_a, "compact": pb.compact, "walk": pb.walk,
               "unfilter": uf.unfilter, "greedy_walk": denc.greedy_walk,
               "lz77_ops": lz.resolve_ops_v13}
    t_phase = time.perf_counter()

    def run(fn):
        for w in counted.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = {k: w.launches for k, w in counted.items()}
        return out

    line = {"phase": "tools"}
    r = run(lambda: trace_v15.trace(streams, dev))
    r["trace_kernels"] = len(r["kernels"])
    r["kernels"] = r["kernels"][:12]
    line["trace_v15"] = r
    line["profile_r3"] = run(lambda: profile_r3.profile(streams[:1] * 16, dev))
    line["profile_encoder"] = run(
        lambda: profile_encoder.profile(corpus[0][2], dev))
    line["profile_corpus"] = run(lambda: profile_corpus.profile(
        [(png, rgba) for _, png, rgba, _, _ in corpus], dev))
    t0 = time.perf_counter()
    png, raw, pix = inputs.k4_png()
    build_s = time.perf_counter() - t0
    if hashlib.sha256(raw).hexdigest() != K4_SCANLINES_SHA256:
        raise AssertionError("k4_png's scanlines changed")
    k4 = {"build_s": build_s, **run(lambda: check_4k_unfilter.check(
        png, raw, pix, dev))}
    del raw, pix
    # Its stream's plan (one call, or the chunked long-stream decode) and
    # one call taken apart.
    stream = png_codec.parse_chunks(png).idat[2:]
    blocks, lengths, cells = scan_stream_cells(stream, CELL_BITS)
    plan = build_plan_v3(stream, blocks, lengths, cells=cells)
    k4["plan"] = {"stream_bytes": len(stream), "blocks": len(blocks),
                  "cells": plan.num_cells, "slots": plan.slots,
                  "stored_bytes": len(plan.stored_val),
                  "out_size": plan.out_size,
                  "long_stream": v15_stream_too_large(plan)}
    del stream, blocks, lengths, cells, plan
    k4["breakdown"] = decode_breakdown(png, dev)
    line["check_4k_unfilter"] = k4
    del png
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "debigulator_tpu_torch.tools.trace_v15",
         "--no-trace"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    wall_ms = (time.perf_counter() - t0) * 1e3
    m = re.search(r"device/batch: ([\d.]+) ms -> ([\d.]+) GB/s", r.stdout)
    if r.returncode != 0 or not m:
        raise AssertionError(f"trace_v15 --no-trace exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    line["trace_v15_cli"] = {"device_ms": float(m.group(1)),
                             "gbps": float(m.group(2)), "wall_ms": wall_ms}
    line["wall_s"] = time.perf_counter() - t_phase
    line["exact"] = True
    return line


def finish(smi: str) -> int:
    """The card's nvidia-smi line, then the last line."""
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    parallel_only = sys.argv[1:] == ["--parallel-only"]
    if sys.argv[1:] and not parallel_only:
        print("usage: chip_smoke.py [--parallel-only]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a machine with an NVIDIA card", file=sys.stderr)
        return 1
    from debigulator_tpu_torch.models.pipeline import decode_gzip_device
    from debigulator_tpu_torch.native import get_lib
    from debigulator_tpu_torch.ops import _kernels
    from debigulator_tpu_torch.ops import inflate as inf
    from debigulator_tpu_torch.ops import phase_a as pa
    from debigulator_tpu_torch.ops import phase_b as pb
    from debigulator_tpu_torch.ops.plan import CELL_BITS, build_plan_v3
    from debigulator_tpu_torch.ops.scanner import scan_stream_cells
    from debigulator_tpu_torch.parallel.merged import (
        build_merged_plan,
        prepare_merged,
    )

    dev = torch.device("cuda")
    smi_all = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    smi = smi_all[0]
    emit({"phase": "card", "nvidia_smi": smi, "cards": smi_all,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- build ---------------------------------------------------------
    t0 = time.perf_counter()
    get_lib()
    native_s = time.perf_counter() - t0
    kernels_s = _kernels.build()
    emit({"phase": "build", "native_s": native_s, "kernels_s": kernels_s})
    base = obj_text()
    streams = make_streams(base, N_STREAMS)
    if parallel_only:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        emit(parallel_phases(dev, base, streams, make_corpus(0), cards)[0])
        torch.cuda.empty_cache()
        emit(multihost_phase(streams, max(2, len(cards))))
        return finish(smi)

    # --- kernels vs plain at ~1.1 MB of output -------------------------
    small = build_merged_plan(streams[:2])
    st_small = inf.stage_plan(small.plan, dev)
    s = stages(st_small, small.plan.slots)
    errs = {"phase_a": max_abs_err(s["a_k"], s["a_p"]),
            "compact": max_abs_err(s["c_k"], s["c_p"]),
            "walk": max_abs_err((s["w_k"],), (s["w_p"],))}
    got = s["w_k"][pb.WINDOW : pb.WINDOW + small.plan.out_size]
    got = got.to(torch.uint8).cpu().numpy()
    for off, size, strm in zip(small.out_offsets, small.out_sizes, streams):
        if got[off : off + size].tobytes() != zlib.decompress(strm, -15):
            raise AssertionError("small merged decode is not bit-exact")
    emit({"phase": "kernels_vs_plain", "out_bytes": small.plan.out_size,
          "cells_pad": int(st_small.pa.cellw.shape[1]),
          "slots": small.plan.slots, "max_abs_err": errs})
    if any(errs.values()):
        raise AssertionError(f"kernel disagrees with its plain version: {errs}")
    del s, st_small

    # --- main path: 29 streams through the user entry points ----------
    out_bytes = N_STREAMS * len(base)
    comp_bytes = sum(map(len, streams))
    pa.phase_a.launches = pb.compact.launches = pb.walk.launches = 0

    def e2e():
        mp = build_merged_plan(streams)
        body = prepare_merged(mp, device=dev)()
        torch.cuda.synchronize()
        return mp, body

    t0 = time.perf_counter()
    mp, body = e2e()
    first_s = time.perf_counter() - t0
    got = body[: mp.plan.out_size].to(torch.uint8).cpu().numpy()
    for off, size, strm in zip(mp.out_offsets, mp.out_sizes, streams):
        if got[off : off + size].tobytes() != zlib.decompress(strm, -15):
            raise AssertionError("main-path decode is not bit-exact")
    del got
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        e2e()
    e2e_s = (time.perf_counter() - t0) / reps
    # Where the host time goes, each the median of 3 calls: the whole host
    # plan; the native scans one after another (build_merged_plan runs
    # them on a thread pool); the per-stream plan builds alone, and with
    # the merge on scanned input; staging the plan on the card.
    scanned = [scan_stream_cells(s, CELL_BITS) for s in streams]
    host = {
        "host_plan_ms": lambda: build_merged_plan(streams),
        "host_scan_serial_ms":
            lambda: [scan_stream_cells(s, CELL_BITS) for s in streams],
        "host_plans_serial_ms":
            lambda: [build_plan_v3(s, b, ln, cells=c)
                     for s, (b, ln, c) in zip(streams, scanned)],
        "host_plan_scanned_ms":
            lambda: build_merged_plan(streams, scanned=scanned),
        "stage_ms": lambda: (prepare_merged(mp, device=dev),
                             torch.cuda.synchronize()),
    }
    host = {k: host_ms(fn) for k, fn in host.items()}
    run = prepare_merged(mp, device=dev)
    torch.cuda.synchronize()
    reps_d = 5
    t0 = time.perf_counter()
    for _ in range(reps_d):
        body = run()
    torch.cuda.synchronize()
    dev_s = (time.perf_counter() - t0) / reps_d
    launches = {"phase_a": pa.phase_a.launches, "compact": pb.compact.launches,
                "walk": pb.walk.launches}
    emit({"phase": "main_path", "streams": N_STREAMS, "out_bytes": out_bytes,
          "compressed_bytes": comp_bytes,
          "compression_ratio": out_bytes / comp_bytes,
          "cells_pad": -(-mp.plan.num_cells // 512) * 512,
          "slots": mp.plan.slots, "bit_exact": True,
          "first_call_s": first_s, "e2e_ms": e2e_s * 1e3,
          "e2e_gbps": out_bytes / e2e_s / 1e9, **host,
          "device_ms": dev_s * 1e3, "device_gbps": out_bytes / dev_s / 1e9,
          "launches": launches})
    require_launches("main_path", launches, launches)

    # --- profile: device busy share and time by kernel -----------------
    run()
    torch.cuda.synchronize()
    prof_reps = 3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(prof_reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / prof_reps
    # One stream, so kernels never overlap: their summed time is the
    # card's busy time.
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / prof_reps
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]
    emit({"phase": "profile", "reps": prof_reps, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
          "kernels_per_call": sum(e.count for e in dev_events) / prof_reps,
          "top": [[e.key[:80], e.self_device_time_total / 1e3 / prof_reps,
                   e.count / prof_reps] for e in top]})

    # --- per-kernel times at the main-path shapes ----------------------
    st = inf.stage_plan(mp.plan, dev)
    slots = mp.plan.slots
    s = stages(st, slots)
    errs_main = {"phase_a": max_abs_err(s["a_k"], s["a_p"]),
                 "compact": max_abs_err(s["c_k"], s["c_p"]),
                 "walk": max_abs_err((s["w_k"],), (s["w_p"],))}
    if any(errs_main.values()):
        raise AssertionError(f"kernel disagrees at main-path shapes: {errs_main}")
    rec = s["rec"]
    mdst, mmeta, rdst, rmeta = s["c_k"]
    out_k = s["init"].clone()
    valid_m = rec.mm != 0
    valid_r = rec.mr != 0

    def library_compact():
        # The same function by library calls: each of the four arrays the
        # wrapper compacts through masked_select (no padding, no fill).
        return (torch.masked_select(rec.dm, valid_m),
                torch.masked_select(rec.mm, valid_m),
                torch.masked_select(rec.dr, valid_r),
                torch.masked_select(rec.mr, valid_r))

    t = {
        "phase_a": (time_ms(lambda: pa.phase_a(st.pa, slots), 10),
                    time_ms(lambda: pa.phase_a_plain(
                        st.pa.cellw, st.pa.cell_block, st.pa.tables, slots), 2),
                    None),
        "compact": (time_ms(lambda: pb.compact(rec, slots), 10),
                    time_ms(lambda: pb.compact_plain(rec, slots), 3),
                    time_ms(library_compact, 10)),
        "walk": (time_ms(lambda: pb.walk(out_k, mdst, mmeta, rdst,
                                         rmeta, rec.lit), 5),
                 time_ms(lambda: pb.walk_plain(s["init"].clone(), mdst, mmeta,
                                               rdst, rmeta, rec.lit), 2),
                 None),
    }
    if not torch.equal(out_k, s["w_k"]):
        raise AssertionError("repeated walk changed its output")
    phase_a_parts = device_parts(lambda: pa.phase_a(st.pa, slots))
    phase_a_replay_ms = replay_ms(lambda: pa.phase_a(st.pa, slots))
    emit(phase_a_phase(dev, st, small.plan))
    compact_repeats = [time_ms(lambda: pb.compact(rec, slots), 10)
                       for _ in range(5)]
    compact_one_array_ms = time_ms(
        lambda: torch.masked_select(rec.dm, valid_m), 10)
    compact_edges = compact_edge_cases(dev)
    emit({"phase": "compact_edge_cases", "max_abs_err": 0,
          "cases": compact_edges})

    # Least time for the same work: bytes each function must move at HBM
    # rate, or its integer operations at the ALU rate, whichever is larger.
    cells_pad = int(st.pa.cellw.shape[1])
    work = walk_work(s["a_k"][5], s["a_k"][1], slots, mp.plan.out_size)
    n_match, n_run, n_lit = work["matches"], work["runs"], work["literals"]
    mlen_total = work["match_bytes"]
    depths_main = chain_depths(out_k.numel(), mdst, mmeta)
    bytes_ = {
        "phase_a": 4 * (st.pa.cellw.numel() + cells_pad + st.pa.tables.numel()
                        + 5 * slots * cells_pad + 2 * cells_pad),
        "compact": 4 * (4 * rec.dm.numel() + 4 * mdst.numel()),
        "walk": work["bytes"],
    }
    ops = {"phase_a": OPS_PER_SYMBOL * (n_lit + 2 * n_match),
           "compact": 0, "walk": 0}
    sources = {"phase_a": ("debigulator_tpu_torch/csrc/phase_a.cu",
                           "debigulator_tpu/ops/phase_a_pallas.py:480"),
               "compact": ("debigulator_tpu_torch/csrc/compact.cu",
                           "debigulator_tpu/ops/phase_b_v15.py:126"),
               "walk": ("debigulator_tpu_torch/csrc/walk.cu",
                        "debigulator_tpu/ops/phase_b_v15.py:308")}
    kernels = []
    for name in ("phase_a", "compact", "walk"):
        ms, plain_ms, lib_ms = t[name]
        b_ms = bytes_[name] / HBM_BYTES_PER_S * 1e3
        o_ms = ops[name] / ALU_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(errs[name], errs_main[name]),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": lib_ms,
        })
    del s, st, rec, out_k, body, run, mdst, mmeta, rdst, rmeta, valid_m, valid_r
    torch.cuda.empty_cache()

    # --- the walk on adversarial shapes -------------------------------
    emit(walk_phases(dev, base))
    torch.cuda.empty_cache()

    # --- the second slice: PNG decode and the encoder -------------------
    corpus = make_corpus(0)
    kernels2, times2 = png_and_encode_phases(dev, corpus)
    kernels += kernels2
    emit({"phase": "kernel_times", "cells_pad": cells_pad, "slots": slots,
          "matches": n_match, "runs": n_run, "literals": n_lit,
          "match_bytes": mlen_total, "bytes_moved": bytes_,
          "walk_chain_depths": depths_main,
          "library_call": {"compact": "torch.masked_select of mdst, mmeta, "
                                      "rdst, rmeta (4 calls)",
                           "unfilter": None, "greedy_walk": None},
          "phase_a_parts": phase_a_parts,
          "phase_a_replay_ms": phase_a_replay_ms,
          "compact_ms_repeats": compact_repeats,
          "compact_library_one_array_ms": compact_one_array_ms,
          **times2})

    # --- other entry points -------------------------------------------
    m1, m2 = base[:300_000], base[200_000:] + base[:50_000]
    gz = gzip.compress(m1, 6) + gzip.compress(m2, 9)
    if decode_gzip_device(gz, device=dev) != gzip.decompress(gz):
        raise AssertionError("two-member gzip decode is not bit-exact")

    long_data = base * 3
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    long_stream = c.compress(long_data) + c.flush()
    blocks, lengths, cells = scan_stream_cells(long_stream, CELL_BITS)
    long_body, n = inf.inflate_device_long_stream(
        long_stream, blocks, lengths, cells, cap_rows=4096, device=dev)
    if long_body[:n].to(torch.uint8).cpu().numpy().tobytes() != long_data:
        raise AssertionError("long-stream chunked decode is not bit-exact")

    rng = np.random.default_rng(13)
    mid = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    mix = c.compress(base[:150_000]) + c.flush(zlib.Z_FULL_FLUSH)
    c0 = zlib.compressobj(0, zlib.DEFLATED, -15)
    mix += c0.compress(mid) + c0.flush(zlib.Z_FULL_FLUSH)
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    mix += c.compress(base[-150_000:]) + c.flush()
    if inf.inflate_device(mix, device=dev) != base[:150_000] + mid + base[-150_000:]:
        raise AssertionError("stored/dynamic mix decode is not bit-exact")
    emit({"phase": "entry_points", "gzip_two_member": True,
          "long_stream_chunks_bytes": n, "stored_mix": True})

    # --- the third slice: the other decode drivers ----------------------
    torch.cuda.empty_cache()
    kernels += fallback_phases(dev, base, streams)

    # --- the fourth slice: the archived decode generations --------------
    torch.cuda.empty_cache()
    kernels += archive_phases(dev, base, streams)

    # --- the fifth slice: the archive and tool kernels with no caller ----
    torch.cuda.empty_cache()
    kernels += archive_kernel_phases(dev, base, streams)

    # --- the thirteenth slice: split-stream decode and the batch layer ---
    torch.cuda.empty_cache()
    line, extra = parallel_phases(dev, base, streams, corpus)
    emit(line)
    for k in kernels:
        k.update(extra.get(k["name"], {}))

    # --- the fifteenth slice: the CLIs, the host encoder, multihost ------
    torch.cuda.empty_cache()
    emit(front_door_phase(dev, base, corpus))
    emit(multihost_phase(streams, 2))

    # --- the sixteenth slice: the tools, after the kernels line's counts
    # were read (the phase resets them) ---------------------------------
    torch.cuda.empty_cache()
    emit(tools_phase(dev, streams, corpus))

    emit({"kernels": kernels})
    return finish(smi)


if __name__ == "__main__":
    sys.exit(main())
