"""One run of one cell: make the inputs from the seed, load the kernels,
warm up the cell's shapes, drive the entry in a closed loop for the
window, then compare a seeded sample of the window's results with the
reference and build the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (the file the configuration names),
``traffic/<traffic>.json`` and ``metrics/<metric>.py``; the generator
parts and the entry those files name are files found by name too
(``parts``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import sys
import tempfile
import time

import torch

from benchmark import inputs, parts, reference
from benchmark.trace import WINDOW, Trace

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
#: Top-level module names that may not be loaded once the window closes:
#: JAX, and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "debigulator_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, spec_path: pathlib.Path | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic and the metrics it reports."""
    spec = json.loads((spec_path or REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=workload,
        config=json.loads((REPO / cfg["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def load_metric(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return parts.load("metrics", name).read


@dataclasses.dataclass
class Entry:
    """What the window drives: ``call(args, device)`` returns a call's
    result, ``outputs(result)`` lists its outputs in host memory, in the
    order of ``reference.expected``."""

    call: object
    outputs: object


def load_entry(name: str) -> Entry:
    """The program's entry of ``entries/<name>.py``."""
    mod = parts.load("entries", name)
    return Entry(mod.call, mod.outputs)


def prepare(device) -> None:
    """Load what every entry needs before its first call: the host library
    and, on a card, the CUDA kernels (built into the program's build
    directory inside the checkout on the first run there)."""
    from debigulator_tpu_torch import native
    from debigulator_tpu_torch.ops import _kernels

    native.get_lib()
    if torch.device(device).type == "cuda":
        _kernels.build()


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    calls: list  # the pool items of the window's calls, in order
    mem_peak_bytes: int
    trace: Trace | None = None


def process_start() -> float:
    """The process's start on the ``time.time()`` clock, from
    ``/proc/self/stat``; now, where that cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (time.clock_gettime(time.CLOCK_BOOTTIME) - start)
    except (OSError, ValueError, IndexError):
        return time.time()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Sampler:
    """A reservoir of ``k`` of the window's results, drawn from the seed:
    every call is equally likely to be kept, whatever their number."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = inputs.rng_for(seed, 99)
        self.kept: list = []
        self.seen = 0

    def offer(self, pool_index: int, result) -> None:
        if len(self.kept) < self.k:
            self.kept.append((pool_index, result))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (pool_index, result)
        self.seen += 1


def _window(call, pool, device, seconds: float, sampler: Sampler,
            traced: bool):
    """Drive ``call`` over the pool, one call after another, until
    ``seconds`` have passed; the window ends with the last call begun
    before then.  Returns (window seconds, items called, failures)."""
    calls, failures, ends = [], [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        k = i % len(pool)
        try:
            with (torch.profiler.record_function("bench.call") if traced
                  else contextlib.nullcontext()):
                out = call(pool[k].args, device)
        except Exception as e:  # noqa: BLE001 - a failed call is counted
            failures.append(f"call {i}: {type(e).__name__}: {e}")
            out = None
        calls.append(pool[k])
        if out is not None:
            sampler.offer(k, out)
        del out
        ends.append(time.perf_counter())
        i += 1
    ms = sorted(1e3 * (b - a) for a, b in zip([t0] + ends, ends))
    if ms:
        print(f"window: {len(ms)} calls, ms a call min {ms[0]:.1f} "
              f"median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}",
              file=sys.stderr)
    return time.perf_counter() - t0, calls, failures


def _forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", call_for=None, t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result line as a dict.

    ``call_for(pool)``, where given, returns the ``Entry`` that stands in
    for the traffic's entry (the control, the fault tests); ``device="cpu"`` runs
    the program's plain versions (the CPU tests).  Raises RuntimeError
    when JAX or the JAX package is loaded."""
    t_start = process_start() if t_start is None else t_start
    tr = cell.traffic
    dev = torch.device(device)
    t = [time.time()]
    pool = inputs.make_pool(cell.config, tr, seed)
    t.append(time.time())
    if call_for is None:
        prepare(dev)
        entry = load_entry(tr["entry"])
    else:
        entry = call_for(pool)
    t.append(time.time())
    for item in pool:  # every shape the window uses, once
        entry.call(item.args, dev)
    _sync(dev)
    t.append(time.time())
    setup_s = t[-1] - t_start
    print(f"setup: {setup_s:.2f} s: start {t[0] - t_start:.2f}, inputs "
          f"{t[1] - t[0]:.2f}, load {t[2] - t[1]:.2f}, warm-up "
          f"{t[3] - t[2]:.2f}", file=sys.stderr)

    sampler = Sampler(int(tr["sample_calls"]), seed)
    trace_rec = None
    if not trace:
        window_s, calls, failures = _window(entry.call, pool, dev, seconds,
                                            sampler, False)
    else:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        span = min(seconds, float(tr["trace_seconds"]))
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                window_s, calls, failures = _window(entry.call, pool, dev,
                                                    span, sampler, True)
                _sync(dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            trace_rec = Trace.from_file(path, calls)
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    bad = _forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded in the run's process: {', '.join(bad)}")

    found = reference.compare(sampler.kept, pool, entry.outputs)
    numbers = {"calls_failed": len(failures), **found}
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in reference.LIMITS.items()}
    correct = bool(sampler.kept) and all(
        c["value"] <= c["limit"] for c in checks.values())
    for f in failures[:5]:
        print(f, file=sys.stderr)

    run = Run(setup_s=setup_s, window_s=window_s, calls=calls,
              mem_peak_bytes=int(mem_peak), trace=trace_rec)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(calls),
              "failed": len(failures), "metrics": metrics,
              "device": device_info(dev, mem_peak)}
    if trace_rec is not None:
        result["device"]["busy_s"] = trace_rec.busy_us() / 1e6
        result["device"]["window_s"] = trace_rec.window_us / 1e6
        result["breakdown"] = {
            "device_ops": trace_rec.device_ops_by_name(10),
            "idle_gaps": trace_rec.idle_by_scope(10)}
    result["checks"] = {**checks, "calls_checked": {
        "value": len(sampler.kept), "limit": 1}}
    return result


def device_info(dev: torch.device, mem_peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(mem_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}

