#!/usr/bin/env python3
"""Rows 1 and 6 of the port's Phase A (csrc/phase_a.cu) timed at every
slots value their wrappers take.

    python3 -m debigulator_tpu_torch.tools.phase_a_slots STREAM [STREAM ...]

Each STREAM is a gzip file (its first member is taken) or a raw DEFLATE
stream.  All of them go through one ``build_merged_plan``, staged on the
card, and ``phase_a`` and ``phase_a_tape`` run on it at slots 8, 16, 32,
64 and 128; a cell with more tokens than slots keeps its first ones.
After a line that describes the plan it prints one JSON line a slots
value with, for each wrapper: ms from CUDA events over REPS calls (the
host's launch cost included), the device ms of one call captured in a
CUDA graph and replayed REPS times, and the bound: the bytes the call
must move at the H100's 3.35 TB/s.  The script uses only the wrappers'
public signatures, so run by its path with another checkout of the
package first on PYTHONPATH it times that checkout's kernels.  Runs on
the card only.
"""

from __future__ import annotations

import json
import sys

import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import phase_a as pa
from debigulator_tpu_torch.parallel.merged import build_merged_plan
from debigulator_tpu_torch.tools.profile_merged import raw_stream

#: Every slots value the wrappers take.
SLOTS = (8, 16, 32, 64, 128)
#: Timed calls (and graph replays) per wrapper and slots value.
REPS = 20
#: H100 SXM HBM3 rate, bytes a second.
HBM_BYTES_PER_S = 3.35e12


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


def _replay_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _events_ms(graph.replay, reps)


def bound_bytes(x: pa.PhaseAInputs, slots: int) -> dict:
    """Bytes each wrapper must move at ``slots``: its inputs read once
    (stream words, block ids, block tables) and its outputs written once
    (five slot-major tapes, counts and lengths; or one token tape and
    counts)."""
    cells = int(x.cellw.shape[1])
    read = x.cellw.numel() + cells + x.tables.numel()
    return {"phase_a": 4 * (read + 5 * slots * cells + 2 * cells),
            "phase_a_tape": 4 * (read + slots * cells + cells)}


def sweep(x: pa.PhaseAInputs, reps: int = REPS) -> list[dict]:
    """Both wrappers on staged inputs ``x`` at every slots value: [{slots,
    phase_a: {ms, replay_ms, bound_ms}, phase_a_tape: {...}}, ...]."""
    rows = []
    for slots in SLOTS:
        row = {"slots": slots}
        nbytes = bound_bytes(x, slots)
        for name, fn in (("phase_a", pa.phase_a),
                         ("phase_a_tape", pa.phase_a_tape)):
            row[name] = {
                "ms": _events_ms(lambda: fn(x, slots), reps),
                "replay_ms": _replay_ms(lambda: fn(x, slots), reps),
                "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3}
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    streams = []
    for path in argv:
        with open(path, "rb") as fh:
            streams.append(raw_stream(fh.read()))
    plan = build_merged_plan(streams).plan
    x = inf.stage_plan(plan, dev).pa
    _, counts = pa.phase_a_tape(x, max(SLOTS))
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "streams": len(streams), "cells_pad": int(x.cellw.shape[1]),
                      "blocks": int(x.tables.shape[0]), "plan_slots": plan.slots,
                      "max_cell_tokens": int(counts.max())}), flush=True)
    for row in sweep(x):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
