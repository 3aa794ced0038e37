#!/usr/bin/env python3
"""Row 11's event chase alone on the card (csrc/microbench_pb.cu,
dbg_microbench_chase): the group walk of the piece-loop microbenchmark.

    python3 -m debigulator_tpu_torch.tools.event_chase

Holds full against microbench_plain on make_pieces' list at 2^16 and 2^21
pieces over a buffer of random words, and every chase variant on
clash_pieces' list; prints, for each make_pieces size, the event count, ms
a call from CUDA events over REPS calls (the plain twin's over one) and
the device ms of each pass from torch.profiler ([name, ms a call,
launches a call]).  It uses only the tool module's functions, so run by
its path with another checkout of the package first on PYTHONPATH it
checks and times that checkout's chase.  Runs on the card only.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.tools import microbench_pb as mb

#: Timed calls of the chase.
REPS = 3


def _events_ms(fn, reps: int) -> float:
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


def _passes(fn, reps: int = REPS) -> list:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return [[e.key[:60], e.self_device_time_total / 1e3 / reps,
             e.count / reps]
            for e in sorted(events, key=lambda e: -e.self_device_time_total)]


def _same(name: str, got, want) -> None:
    err = int((got.long() - want.long()).abs().max())
    print(f"{name}: max_abs_err {err}", flush=True)
    if err:
        raise AssertionError(f"{name} disagrees with its plain version")


def main() -> int:
    dev = resolve_device("cuda")
    print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    rand = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (mb.ROWS, 128)).astype(np.int32)).to(dev)
    for n in (1 << 16, mb.N_PIECES):
        w0, w1 = (torch.from_numpy(w).to(dev) for w in mb.make_pieces(n))
        _same(f"full at {n} pieces", mb.microbench("full", w0, w1, rand),
              mb.microbench_plain("full", w0, w1, rand))
        plan = mb._plan("full", w0, w1, rand.numel(), mb.STAGE_ROWS)
        out = rand.clone()

        def chase():
            mb._launch("full", w0, w1, out, mb.STAGE_ROWS, plan)

        print(json.dumps({
            "pieces": n, "events": plan[1], "ms": _events_ms(chase, REPS),
            "plain_ms": _events_ms(
                lambda: mb.microbench_plain("full", w0, w1, rand), 1),
            "passes": _passes(chase)}), flush=True)
    w0, w1, init = (torch.from_numpy(x).to(dev) for x in mb.clash_pieces())
    for v in mb.CHASE:
        _same(f"{v} on the clashing list", mb.microbench(v, w0, w1, init),
              mb.microbench_plain(v, w0, w1, init))
    return 0


if __name__ == "__main__":
    sys.exit(main())
