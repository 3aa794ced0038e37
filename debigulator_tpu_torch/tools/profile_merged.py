#!/usr/bin/env python3
"""Where the time goes in the host-fed merged decode, against the
flagship (the port of tools/profile_merged.py).

    python3 -m debigulator_tpu_torch.tools.profile_merged STREAM [K ...]

STREAM is a gzip file (its first member is taken) or a raw DEFLATE
stream; each K (default 16) decodes K copies of it as one merged batch
and prints, in ms: the host scan with records (``build_merged_plan(...,
records=True)``), the host-fed prep (``pack_groups`` and the piece words,
``host_fed.build_v9_arrays``), the host-fed decode on the device
(``inflate_v10``) and the flagship decode of the same batch
(``prepare_merged`` then the runner), each checked against the serial
native inflate.  Device times are host clocks around work that ends in a
synchronise, the mean of ``--reps`` calls after one warm-up.  Runs on the
card; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.models.gzip_codec import parse_first_member
from debigulator_tpu_torch.native.scanner import inflate_native
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops.archive import host_fed, inflate_generations
from debigulator_tpu_torch.parallel.merged import (
    MergedPlan,
    build_merged_plan,
    prepare_merged,
)


def sync(dev: torch.device) -> None:
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mean_ms(fn, dev: torch.device, reps: int) -> float:
    """Mean wall ms of ``reps`` calls of ``fn`` after one warm-up call,
    host clocks around work that ends in a synchronise."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def raw_stream(data: bytes) -> bytes:
    """The DEFLATE stream of a gzip file's first member, or ``data``."""
    if data[:2] == b"\x1f\x8b":
        m = parse_first_member(data)
        return bytes(data[m.deflate_start : m.deflate_end])
    return data


def host_fed_inputs(streams: list[bytes], device="cuda"):
    """The host side of the host-fed decode: (merged plan with records,
    piece arrays and stored bytes on ``device``, n_seg, host ms)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    mp = build_merged_plan(streams, records=True)
    t1 = time.perf_counter()
    n_seg = inf.n_segments(mp.plan.out_size)
    v9 = host_fed.build_v9_arrays(mp, n_seg, device=dev)
    stored = (torch.from_numpy(np.asarray(mp.plan.stored_pos, np.int32)).to(dev),
              torch.from_numpy(np.asarray(mp.plan.stored_val, np.uint8)).to(dev))
    sync(dev)
    t2 = time.perf_counter()
    return mp, v9, stored, n_seg, {"host_scan_ms": (t1 - t0) * 1e3,
                                   "v9_prep_ms": (t2 - t1) * 1e3}


def check(body: torch.Tensor, mp: MergedPlan, wants: list[bytes]) -> None:
    got = body[: mp.plan.out_size].to(torch.uint8).cpu().numpy()
    for off, size, want in zip(mp.out_offsets, mp.out_sizes, wants,
                               strict=True):
        if got[off : off + size].tobytes() != want:
            raise AssertionError("decode is not bit-exact")


def profile(streams: list[bytes], device="cuda", reps: int = 5) -> dict:
    """One merged batch through the host-fed and the flagship decodes:
    host ms, device ms of each decode, output bytes."""
    dev = resolve_device(device)
    wants = [inflate_native(s)[0] for s in streams]
    mp, v9, stored, n_seg, out = host_fed_inputs(streams, dev)
    check(inflate_generations.inflate_v10(v9, *stored, n_seg), mp, wants)
    out["host_fed_ms"] = mean_ms(
        lambda: inflate_generations.inflate_v10(v9, *stored, n_seg), dev, reps)
    flat = build_merged_plan(streams)
    run = prepare_merged(flat, device=dev)
    check(run(), flat, wants)
    out["flagship_ms"] = mean_ms(run, dev, reps)
    out["out_bytes"] = mp.plan.out_size
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stream", help="a gzip file or a raw DEFLATE stream")
    ap.add_argument("k", nargs="*", type=int, default=[16],
                    help="copies of the stream per batch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    with open(args.stream, "rb") as f:
        stream = raw_stream(f.read())
    for k in args.k:
        r = profile([stream] * k, device=args.device, reps=args.reps)
        mb = r["out_bytes"] / 1e6
        print(f"K={k:3d} out={mb:7.2f} MB  host_scan={r['host_scan_ms']:7.1f} ms"
              f"  v9_prep={r['v9_prep_ms']:7.1f} ms"
              f"  host_fed={r['host_fed_ms']:7.2f} ms"
              f"  flagship={r['flagship_ms']:7.2f} ms"
              f"  -> {mb / r['host_fed_ms']:6.3f} / "
              f"{mb / r['flagship_ms']:6.3f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
