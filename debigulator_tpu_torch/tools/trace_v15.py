#!/usr/bin/env python3
"""A device trace of the flagship decode of one merged batch, with its time
by op and by kernel (the port of tools/trace_v15.py).

    python3 -m debigulator_tpu_torch.tools.trace_v15 [K] [--no-trace]

K (default 29) rotations of the synthetic OBJ text (``tools/inputs``:
``make_streams(obj_text(), K)``, levels 6-9) as one merged plan
(``build_merged_plan(records=False)``) staged by ``prepare_merged``.  One
``run()`` is checked against zlib; then the mean ms of 3 ``run()`` calls
(host clocks around work that ends in a synchronise) and GB/s of decoded
bytes; then, unless ``--no-trace``, a ``torch.profiler`` trace of 3 more
calls, written to a new temporary directory, and a call's share of it: the
top 25 ops (events over 100 us summed by name) and every CUDA kernel of
the trace (one stream's kernels run under that cut).  Runs on the card;
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import zlib

import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.parallel.merged import build_merged_plan, prepare_merged
from debigulator_tpu_torch.tools.inputs import N_STREAMS, make_streams, obj_text
from debigulator_tpu_torch.tools.profile_merged import check, mean_ms
from debigulator_tpu_torch.utils.profiling import (
    device_trace,
    trace_kernel_summary,
    trace_op_summary,
)

#: Calls timed, and calls traced.
REPS = 3


def trace(streams: list[bytes], device="cuda", traced: bool = True) -> dict:
    """One merged batch of ``streams`` through the flagship decode: its
    device ms and GB/s and, when ``traced``, a call's top ops ([ms, name])
    and kernels ([ms, launches, name]) from a trace of REPS calls."""
    dev = resolve_device(device)
    wants = [zlib.decompress(s, -15) for s in streams]
    mp = build_merged_plan(streams, records=False)
    run = prepare_merged(mp, device=dev)
    check(run(), mp, wants)
    ms = mean_ms(run, dev, REPS)
    out = {"streams": len(streams), "out_bytes": mp.plan.out_size,
           "slots": mp.plan.slots, "device_ms": ms,
           "gbps": mp.plan.out_size / ms / 1e6}
    if traced:
        logdir = tempfile.mkdtemp(prefix="dbg_trace_v15_")
        with device_trace(logdir, device=dev):
            for _ in range(REPS):
                body = run()
        check(body, mp, wants)
        out["logdir"] = logdir
        out["top_ops"] = [[t / REPS, name]
                          for t, name in trace_op_summary(logdir, top=25)]
        out["kernels"] = [[t / REPS, n / REPS, name] for t, n, name
                          in trace_kernel_summary(logdir, top=None)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("k", nargs="?", type=int, default=N_STREAMS,
                    help="streams in the batch (default 29)")
    ap.add_argument("--no-trace", action="store_true",
                    help="time the calls, take no trace")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    r = trace(make_streams(obj_text(), args.k), dev, not args.no_trace)
    print(f"K={r['streams']} out={r['out_bytes'] / 1e6:.2f} MB "
          f"slots={r['slots']}  device/batch: {r['device_ms']:.3f} ms -> "
          f"{r['gbps']:.3f} GB/s", flush=True)
    if "logdir" in r:
        print(f"trace in {r['logdir']}; top ops, ms a call:")
        for t, name in r["top_ops"]:
            print(f"  {t:9.3f} ms  {name}")
        print("device kernels, ms and launches a call:")
        for t, n, name in r["kernels"]:
            print(f"  {t:9.4f} ms  {n:5.1f}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
