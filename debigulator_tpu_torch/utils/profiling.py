"""Tracing and profiling hooks (the port of
debigulator_tpu/utils/profiling.py).

The reference's own observability is wall-clock printf; here
``torch.profiler`` traces (Chrome trace JSON, readable in Perfetto or
chrome://tracing) around any pipeline section, named scopes per phase
(``record_function``, plus an NVTX range once CUDA is in use), and a
trace summariser that attributes time to ops by name.  Host-side phase
timing lives in utils.logging.PhaseLog.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
import time

import torch

from debigulator_tpu_torch.device import resolve as resolve_device

#: Where ``device_trace`` writes when no directory is given.
DEFAULT_LOGDIR = os.path.join(tempfile.gettempdir(), "dbg_trace")


@contextlib.contextmanager
def device_trace(logdir: str = DEFAULT_LOGDIR, device="cuda"):
    """Profile the enclosed block and write a Chrome trace into ``logdir``.

    Traces CPU and CUDA activity; the CPU alone only when the caller asks
    for ``device="cpu"`` (the default raises without a card).  Yields
    ``logdir``; the trace is written when the block exits.
    """
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def named_scope(name: str):
    """A named range around a phase: a ``record_function`` event in a
    profiler trace (on the card also its span over the phase's kernels)
    and, once CUDA is in use, an NVTX range."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_initialized():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _trace_events(logdir: str):
    """Every event of the Chrome traces under ``logdir`` (``.json`` or
    ``.json.gz``, any depth)."""
    files = (glob.glob(f"{logdir}/**/*.json", recursive=True)
             + glob.glob(f"{logdir}/**/*.json.gz", recursive=True))
    for f in files:
        opener = gzip.open if f.endswith(".gz") else open
        with opener(f, "rt") as fh:
            yield from json.load(fh).get("traceEvents", [])


def trace_op_summary(logdir: str, top: int = 15) -> list[tuple[float, str]]:
    """(total_ms, name) rows of the traces under ``logdir``: complete
    ("X") events longer than 100 us, summed by name, largest first."""
    agg: dict[str, float] = {}
    for e in _trace_events(logdir):
        if e.get("ph") == "X" and e.get("dur", 0) > 100:
            agg[e.get("name", "?")] = agg.get(e.get("name", "?"), 0) + e["dur"]
    rows = sorted(((v / 1e3, k) for k, v in agg.items()), reverse=True)
    return rows[:top]


def trace_kernel_summary(logdir: str,
                         top: int | None = 10) -> list[tuple[float, int, str]]:
    """(total_ms, launches, name) rows of the CUDA kernels in the traces
    under ``logdir``, summed by name, largest first (all of them with
    ``top=None``), however short each launch: the kernels of one call on a
    small input run microseconds, below ``trace_op_summary``'s cut.  Empty
    for a CPU trace."""
    agg: dict[str, list] = {}
    for e in _trace_events(logdir):
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            row = agg.setdefault(e.get("name", "?"), [0.0, 0])
            row[0] += e.get("dur", 0)
            row[1] += 1
    rows = sorted(((v[0] / 1e3, v[1], k) for k, v in agg.items()),
                  reverse=True)
    return rows[:top]
