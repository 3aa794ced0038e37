"""Reduction of a traced run: from ``torch.profiler``'s Chrome trace to the
device's busy time, its idle gaps by the host span they fall in, device
time by kernel name and under the program's scopes.

The per-layer metric readers (``benchmark/metrics``) read a ``Trace``; the
CPU tests build one from a small recorded event list.
"""

from __future__ import annotations

import bisect
import collections
import json

#: Trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Trace categories of the host calls that launch device work.
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: The benchmark's span around the traced window.
WINDOW = "bench.window"


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The complete events of one traced window (times in microseconds).

    ``calls`` are the pool items of the calls made in the window, in
    order: the work each did, from the benchmark's own data."""

    def __init__(self, events: list[dict], calls: list):
        self.calls = calls
        xs = [e for e in events if e.get("ph") == "X"]
        win = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise ValueError(f"the trace has no {WINDOW!r} span")
        w = max(win, key=lambda e: e.get("dur", 0))
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = str(w.get("tid"))
        inside = [e for e in xs if self.t0 <= float(e["ts"]) <= self.t1]
        self.device_ops = [e for e in inside if e.get("cat") in DEVICE_CATS]
        self.annotations = [e for e in inside
                            if e.get("cat") == "user_annotation"
                            and e.get("name") != WINDOW]
        self.launches = {}
        for e in inside:
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launches[corr] = e

    @classmethod
    def from_file(cls, path: str, calls: list) -> "Trace":
        with open(path) as fh:
            return cls(json.load(fh).get("traceEvents", []), calls)

    # -- the window and the device ---------------------------------------

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy(self):
        """Merged intervals in which an operation ran on the device,
        clipped to the window."""
        return _union((max(float(e["ts"]), self.t0),
                       min(float(e["ts"]) + float(e.get("dur", 0)), self.t1))
                      for e in self.device_ops)

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())

    def gaps(self):
        """The window's idle intervals on the device."""
        out, at = [], self.t0
        for s, e in self.busy():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def idle_by_scope(self, top: int = 10) -> list[list]:
        """[name, seconds] of the device's idle time by the innermost host
        span of the window's thread that it falls in (``outside_spans``
        where none), largest first."""
        evs = []
        for a in self.annotations:
            if str(a.get("tid")) != self.main_tid:
                continue
            s = float(a["ts"])
            evs.append((s, 1, a["name"]))
            evs.append((s + float(a.get("dur", 0)), -1, a["name"]))
        for s, e in self.gaps():
            evs.append((s, 2, None))
            evs.append((e, -2, None))
        evs.sort(key=lambda x: (x[0], x[1]))
        acc: dict[str, float] = collections.defaultdict(float)
        stack: list[str] = []
        in_gap, last = False, None
        for t, kind, name in evs:
            if in_gap and last is not None and t > last:
                acc[stack[-1] if stack else "outside_spans"] += t - last
            last = t
            if kind == 1:
                stack.append(name)
            elif kind == -1:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i] == name:
                        del stack[i]
                        break
            else:
                in_gap = kind == 2
        rows = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e6] for k, v in rows]

    def device_ops_by_name(self, top: int = 10) -> list[list]:
        """[name, seconds] of device time by operation name, largest
        first."""
        acc: dict[str, float] = collections.defaultdict(float)
        for e in self.device_ops:
            acc[e.get("name", "?")] += float(e.get("dur", 0))
        rows = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e6] for k, v in rows]

    def kernel_count(self) -> int:
        return sum(1 for e in self.device_ops if e.get("cat") == "kernel")

    def kernel_us(self, part: str) -> float:
        """Device time of the kernels whose name contains ``part``."""
        return sum(float(e.get("dur", 0)) for e in self.device_ops
                   if e.get("cat") == "kernel" and part in e.get("name", ""))

    # -- host spans ------------------------------------------------------

    def device_us_under(self, scopes) -> float:
        """Device time of the operations launched inside a host span named
        in ``scopes``, by the launch's correlation with the operation."""
        scopes = set(scopes)
        by_tid: dict[str, list] = collections.defaultdict(list)
        for a in self.annotations:
            if a.get("name") in scopes:
                s = float(a["ts"])
                by_tid[str(a.get("tid"))].append((s, s + float(a["dur"])))
        for v in by_tid.values():
            v.sort()
        total = 0.0
        for e in self.device_ops:
            launch = self.launches.get((e.get("args") or {}).get("correlation"))
            if launch is None:
                continue
            ivs = by_tid.get(str(launch.get("tid")), [])
            t = float(launch["ts"])
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
                total += float(e.get("dur", 0))
        return total
