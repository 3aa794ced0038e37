"""Tracing and profiling hooks (the port of
debigulator_tpu/utils/profiling.py).

The reference's own observability is wall-clock printf; here
``torch.profiler`` traces (Chrome trace JSON, readable in Perfetto or
chrome://tracing) around any pipeline section, ``named_scope``: the one
span primitive, around each layer of a decode, and a trace summariser that
attributes time to ops by name.

A span is a ``record_function`` range while a profiler runs on the
calling thread, an NVTX range while an NVTX tool (nsys, ncu) is attached,
and, inside a request span at verbosity 1 or more, a timed entry of the
``[dbg]`` lines (``utils.logging``): one summary line a request at -v,
one line a span at -vv.  With none of these, entering and leaving a span
is a few attribute reads.  Spans launch nothing and synchronise nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import glob
import gzip
import json
import os
import tempfile
import time

import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.utils.logging import log, verbosity

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


#: True while a profiler records this thread's ``record_function`` ranges.
_profiler_on = torch._C._autograd._profiler_enabled
#: An NVTX tool is attached: nsys and ncu start the process with their
#: injection library in ``NVTX_INJECTION64_PATH``.
_NVTX_TOOL = bool(os.environ.get("NVTX_INJECTION64_PATH"))


def layer_of(name: str) -> str:
    """The layer a span's time counts to: ``<layer>`` of ``dbg.<layer>``
    and ``dbg.<layer>.<part>``; any other span is its own layer."""
    if name.startswith("dbg."):
        return name[4:].split(".", 1)[0]
    return name


class _SpanLog:
    """The spans of one request on one thread, timed for the ``[dbg]``
    lines: a stack of [name, start ns, ns covered by children] and the
    self time by layer."""

    __slots__ = ("stack", "layers", "token")

    def __init__(self):
        self.stack: list[list] = []
        self.layers: dict[str, int] = {}
        self.token = None

    def enter(self, name: str) -> None:
        self.stack.append([name, time.perf_counter_ns(), 0])

    def exit(self) -> None:
        name, t0, child = self.stack.pop()
        dur = time.perf_counter_ns() - t0
        own = dur - child
        log(2, name, ms=dur / 1e6, self_ms=own / 1e6)
        if self.stack:
            self.stack[-1][2] += dur
            layer = layer_of(name)
            self.layers[layer] = self.layers.get(layer, 0) + own
        else:
            log(1, layer_of(name), total_ms=dur / 1e6,
                **{f"{k}_ms": v / 1e6 for k, v in self.layers.items()},
                other_ms=own / 1e6)


#: The open request's ``_SpanLog`` in this context (a thread's own: a
#: worker thread starts with none); None outside one or at verbosity 0.
_span_log: contextvars.ContextVar[_SpanLog | None] = contextvars.ContextVar(
    "dbg_span_log", default=None)


class named_scope:
    """A named span around one layer of the work::

        with named_scope("dbg.plan"):
            plan = build_plan_v3(...)

    A ``record_function`` range while a profiler runs on this thread (on
    the card also the span of the kernels launched inside it), an NVTX
    range while an NVTX tool is attached.  ``request=True`` marks a
    request's outermost span (a decode entry): at verbosity 1 or more it
    times the spans opened inside it on its thread and, as it closes,
    logs one summary line with ``total_ms``, a ``<layer>_ms`` field of
    self time a layer (``layer_of``) and ``other_ms``, its own; at 2 also
    a line a span as each closes.  Spans on other threads are not timed
    there."""

    __slots__ = ("name", "request", "_on", "_rf", "_nvtx", "_log")

    def __init__(self, name: str, request: bool = False):
        self.name = name
        self.request = request

    def __enter__(self):
        # The off path: four reads, so that spans can stay in hot loops.
        self._on = (_profiler_on() or _NVTX_TOOL or self.request
                    or _span_log.get() is not None)
        if self._on:
            self._enter()
        return self

    def __exit__(self, *exc):
        if self._on:
            self._exit(exc)
        return False

    def _enter(self) -> None:
        self._rf = None
        if _profiler_on():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._nvtx = _NVTX_TOOL and torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        span_log = _span_log.get()
        if span_log is None and self.request and verbosity() >= 1:
            span_log = _SpanLog()
            span_log.token = _span_log.set(span_log)
        if span_log is not None:
            span_log.enter(self.name)
        self._log = span_log

    def _exit(self, exc) -> None:
        span_log = self._log
        if span_log is not None:
            span_log.exit()
            if not span_log.stack:
                _span_log.reset(span_log.token)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)


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
