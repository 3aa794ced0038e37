#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (debigulator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the host library and the CUDA kernels from this checkout, holds
every kernel bit-exact against its plain PyTorch version on the card, then
runs the main path at full size: 29 distinct raw DEFLATE streams of about
562 KB each (the shape of bench.py's workload, synthetic OBJ-like text
made from a fixed seed) through build_merged_plan -> prepare_merged -> run
on "cuda", every stream checked against zlib.  It then decodes a
two-member gzip file, a long stream through the chunked decode and a
stored/dynamic mix.  Each phase prints one JSON line; the line before the
last is the card's name and power limit as nvidia-smi reports them, and
the last line is {"ok": true, "device": {...}}.  Any mismatch or launch
error raises and the script exits non-zero without that line.
"""

from __future__ import annotations

import gzip
import json
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

#: H100 SXM published peaks (NVIDIA data sheet, as listed in the repo's
#: measurement notes): HBM bandwidth, and the non-tensor 32-bit rate that
#: the integer work of these kernels is counted against.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
#: Rough integer operations per decoded Huffman symbol in Phase A (15-length
#: probe with telescoped offset, table lookup, window and state update).
OPS_PER_SYMBOL = 120

N_STREAMS = 29
BASE_BYTES = 561_872


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def obj_text(seed: int = 0, size: int = BASE_BYTES) -> bytes:
    """Wavefront-OBJ-like text (v / vt / vn / f lines on a coarse grid, so
    lines repeat the way exported meshes do), made from a numpy seed."""
    rng = np.random.default_rng(seed)
    parts = ["# Blender v2.79 (sub 0) OBJ File: ''\n# www.blender.org\n"
             "mtllib sample.mtl\n"]
    total, n, obj = len(parts[0]), 0, 0
    while total < size:
        obj += 1
        nv = int(rng.integers(40, 120))
        v = rng.integers(-24, 25, (nv, 3)) / 8.0
        vt = rng.integers(0, 17, (nv, 2)) / 16.0
        vn = rng.integers(-1, 2, (nv, 3)).astype(float)
        lines = [f"o Mesh.{obj:03d}"]
        lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
        lines += [f"vt {u:.6f} {w:.6f}" for u, w in vt]
        lines += [f"vn {x:.4f} {y:.4f} {z:.4f}" for x, y, z in vn]
        lines += ["usemtl Material.001", "s off"]
        for _ in range(nv):
            idx = n + rng.integers(1, nv + 1, 3)
            lines.append("f " + " ".join(f"{a}/{a}/{a}" for a in idx))
        n += nv
        chunk = "\n".join(lines) + "\n"
        parts.append(chunk)
        total += len(chunk)
    return "".join(parts).encode()[:size]


def make_streams(base: bytes, k: int) -> list[bytes]:
    """bench.py's _make_streams: rotate the content, compress at 6..9."""
    streams = []
    for i in range(k):
        rot = (i * 40961) % len(base)
        c = zlib.compressobj(6 + (i % 4), zlib.DEFLATED, -15)
        streams.append(c.compress(base[rot:] + base[:rot]) + c.flush())
    return streams


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
    s8 = pb.size8(mdst, mmeta)
    init = pb.init_body(st.n_seg, st.stored_pos, st.stored_val,
                        device=mdst.device)
    w_k = pb.walk(init.clone(), mdst, mmeta, s8, rdst, rmeta, rec.lit,
                  stream_starts=st.stream_starts)
    w_p = pb.walk_plain(init.clone(), mdst, mmeta, rdst, rmeta, rec.lit)
    torch.cuda.synchronize()
    return {"a_k": a_k, "a_p": a_p, "rec": rec, "c_k": c_k, "c_p": c_p,
            "s8": s8, "init": init, "w_k": w_k, "w_p": w_p}


def main() -> int:
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- build ---------------------------------------------------------
    t0 = time.perf_counter()
    get_lib()
    native_s = time.perf_counter() - t0
    kernels_s = _kernels.build()
    emit({"phase": "build", "native_s": native_s, "kernels_s": kernels_s})

    # --- kernels vs plain at ~1.1 MB of output -------------------------
    base = obj_text()
    streams = make_streams(base, N_STREAMS)
    small = build_merged_plan(streams[:2])
    st_small = inf.stage_plan(small.plan, dev, small.out_offsets)
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
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

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
    st = inf.stage_plan(mp.plan, dev, mp.out_offsets)
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
    t = {
        "phase_a": (time_ms(lambda: pa.phase_a(st.pa, slots), 10),
                    time_ms(lambda: pa.phase_a_plain(
                        st.pa.cellw, st.pa.cell_block, st.pa.tables, slots), 2),
                    None),
        "compact": (time_ms(lambda: pb.compact(rec, slots), 10),
                    time_ms(lambda: pb.compact_plain(rec, slots), 3),
                    time_ms(lambda: torch.masked_select(rec.dm, valid_m), 10)),
        "walk": (time_ms(lambda: pb.walk(out_k, mdst, mmeta, s["s8"], rdst,
                                         rmeta, rec.lit,
                                         stream_starts=st.stream_starts), 5),
                 time_ms(lambda: pb.walk_plain(s["init"].clone(), mdst, mmeta,
                                               rdst, rmeta, rec.lit), 2),
                 None),
    }
    if not torch.equal(out_k, s["w_k"]):
        raise AssertionError("repeated walk changed its output")

    # Least time for the same work: bytes each function must move at HBM
    # rate, or its integer operations at the ALU rate, whichever is larger.
    cells_pad = int(st.pa.cellw.shape[1])
    cnt = s["a_k"][5].long()
    n_match = int(((cnt >> 16) & 0xFF).sum())
    n_run = int(((cnt >> 8) & 0xFF).sum())
    n_lit = int((cnt & 0xFF).sum())
    mlen_total = int((mmeta.long() >> 16).sum())
    bytes_ = {
        "phase_a": 4 * (st.pa.cellw.numel() + cells_pad + st.pa.tables.numel()
                        + 5 * slots * cells_pad + 2 * cells_pad),
        "compact": 4 * (4 * rec.dm.numel() + 4 * mdst.numel()),
        "walk": 4 * (2 * n_run + n_lit + 3 * n_match + mlen_total
                     + mp.plan.out_size),
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
    emit({"phase": "kernel_times", "cells_pad": cells_pad, "slots": slots,
          "matches": n_match, "runs": n_run, "literals": n_lit,
          "match_bytes": mlen_total, "bytes_moved": bytes_,
          "library_call": {"compact": "torch.masked_select(dst, meta != 0)"}})
    del s, st, rec, out_k, body, run

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

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
