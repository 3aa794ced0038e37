"""Self time of the program's layer spans in a traced run.

The program opens a span ``dbg.<layer>`` or ``dbg.<layer>.<part>``
(``utils/profiling.named_scope``) around each host layer of a decode: the
parse, the scan, the plan, staging, the checks, unfilter and read-back.  A
span's self time is its length, clipped to ``bench.window``, less the part
of it that its child spans on the same thread cover; a layer's time is the
sum of the self times of its spans.  A span nested in another layer's (a
chunk's CRC-32, ``dbg.check``, inside ``dbg.parse``) counts to its own
layer alone.
"""

from __future__ import annotations

import collections

#: The prefix of the program's layer spans.
PREFIX = "dbg."


def layer_of(name: str) -> str | None:
    """``<layer>`` of ``dbg.<layer>`` and ``dbg.<layer>.<part>``; None for
    any other span."""
    if not name.startswith(PREFIX):
        return None
    return name[len(PREFIX):].split(".", 1)[0]


def self_us(spans) -> list[float]:
    """Self times of ``spans``, (start, end) on one thread, in their order:
    each one's length less the part its children cover."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][0], -spans[i][1]))
    own = [e - s for s, e in spans]
    stack: list[int] = []
    for i in order:
        s, e = spans[i]
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        if stack:
            own[stack[-1]] -= min(e, spans[stack[-1]][1]) - s
        stack.append(i)
    return own


def layer_us(trace) -> dict[str, float]:
    """Self time by layer of the window's spans, every thread's."""
    by_tid: dict[str, list] = collections.defaultdict(list)
    for a in trace.annotations:
        s = float(a["ts"])
        e = min(s + float(a.get("dur", 0)), trace.t1)
        by_tid[str(a.get("tid"))].append((s, e, a.get("name", "")))
    acc: dict[str, float] = collections.defaultdict(float)
    for spans in by_tid.values():
        for (_, _, name), us in zip(spans, self_us([x[:2] for x in spans])):
            layer = layer_of(name)
            if layer is not None:
                acc[layer] += us
    return dict(acc)


def ms_per_MB(run, layer: str) -> float | None:
    """Self time of ``layer``'s spans in ms a decoded MB of the traced
    window's calls; None where the run was not traced, drove no device
    (the CPU tests' runs: the host of no card), or the program marks no
    such span (a program older than its spans)."""
    t = run.trace
    if t is None or not t.device_ops:
        return None
    us = layer_us(t).get(layer)
    mb = sum(c.out_bytes for c in t.calls) / 1e6
    if us is None or not mb:
        return None
    return us / 1e3 / mb
