#!/usr/bin/env python3
"""Where the time goes in the v13 decode of K copies of one stream: host
plan, staging, Phase A alone and the whole device decode (the port of
tools/profile_r3.py).

    python3 -m debigulator_tpu_torch.tools.profile_r3 [K ...] [--stream FILE]

Each K (default 16) decodes K copies of one DEFLATE stream as one merged
batch: the first of ``tools/inputs.make_streams(obj_text(), 1)``, or the
gzip file or raw DEFLATE stream given with ``--stream``.  Prints, in ms:
the host plan (``build_merged_plan(records=False)``), the staging of its
device inputs (``ops/phase_a.build_phase_a_inputs`` and
``stage_phase_a_inputs``, ``ops/plan.plan_arrays_v7``, then a
synchronise), Phase A alone (``ops/phase_a.phase_a``: the table kernel,
then the decode) and ``ops/inflate.inflate_v13`` (Phase A, then the op
kernel) with its GB/s; then whether every copy is bit-exact and the tapes
did not overflow, and raises if not.  Device times are host clocks around
work that ends in a synchronise, the mean of ``--reps`` calls after one
warm-up, on inputs staged once.  Runs on the card; ``--device cpu`` runs
the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.native import get_lib
from debigulator_tpu_torch.native.scanner import inflate_native
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import phase_a as pa
from debigulator_tpu_torch.ops.plan import plan_arrays_v7
from debigulator_tpu_torch.parallel.merged import build_merged_plan
from debigulator_tpu_torch.tools.inputs import make_streams, obj_text
from debigulator_tpu_torch.tools.profile_merged import (
    check,
    mean_ms,
    raw_stream,
    sync,
)


def stage(streams: list[bytes], device="cuda"):
    """The host plan of ``streams`` and its staged v13 inputs: (merged plan,
    Phase A inputs, stored-block arrays, n_seg, {host_plan_ms, stage_ms})."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    mp = build_merged_plan(streams, records=False)
    t1 = time.perf_counter()
    pa_in = pa.stage_phase_a_inputs(pa.build_phase_a_inputs(mp.plan), dev)
    arrays = plan_arrays_v7(mp.plan, dev)
    sync(dev)
    t2 = time.perf_counter()
    return (mp, pa_in, arrays, inf.n_segments(mp.plan.out_size),
            {"host_plan_ms": (t1 - t0) * 1e3, "stage_ms": (t2 - t1) * 1e3})


def profile(streams: list[bytes], device="cuda", reps: int = 5) -> dict:
    """One merged batch of ``streams`` through the v13 decode: host plan,
    staging, Phase A and v13 ms, shapes; raises unless bit-exact."""
    dev = resolve_device(device)
    # The native library loaded and the card's context made before the
    # clocks start: a first call would count them as host plan and staging.
    get_lib()
    torch.zeros(1, device=dev)
    sync(dev)
    mp, pa_in, arrays, n_seg, out = stage(streams, dev)
    slots = mp.plan.slots
    out["phase_a_ms"] = mean_ms(lambda: pa.phase_a(pa_in, slots), dev, reps)
    out["v13_ms"] = mean_ms(
        lambda: inf.inflate_v13(pa_in, arrays, slots, n_seg), dev, reps)
    body, overflow = inf.inflate_v13(pa_in, arrays, slots, n_seg)
    if bool(overflow):
        raise AssertionError("a Phase A tape overflowed its slots")
    check(body, mp, [inflate_native(s)[0] for s in streams])
    out.update(streams=len(streams), out_bytes=mp.plan.out_size,
               cells=mp.plan.num_cells, slots=slots, n_seg=n_seg,
               gbps=mp.plan.out_size / out["v13_ms"] / 1e6, bit_exact=True,
               overflow=False)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("k", nargs="*", type=int, default=[16],
                    help="copies of the stream per batch")
    ap.add_argument("--stream", help="a gzip file or a raw DEFLATE stream "
                                     "(default: the synthetic OBJ text)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.stream:
        with open(args.stream, "rb") as f:
            stream = raw_stream(f.read())
    else:
        stream = make_streams(obj_text(), 1)[0]
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    for k in args.k:
        r = profile([stream] * k, dev, args.reps)
        print(f"K={k} out={r['out_bytes'] / 1e6:.2f} MB cells={r['cells']} "
              f"slots={r['slots']} n_seg={r['n_seg']} "
              f"host={r['host_plan_ms']:.1f} ms stage={r['stage_ms']:.1f} ms",
              flush=True)
        print(f"  phase A alone : {r['phase_a_ms']:8.3f} ms", flush=True)
        print(f"  v13 full      : {r['v13_ms']:8.3f} ms -> "
              f"{r['gbps']:.3f} GB/s device", flush=True)
        print(f"  bit-exact: {r['bit_exact']} overflow={r['overflow']}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
