"""The arithmetic the metric files share.  Each file under ``metrics/`` is
one metric, named as in ``BENCHMARK.json``, with a ``read(run)`` that
returns its value, or None where the run holds nothing to read (the
harness then leaves the metric out of the line).

``run`` is a ``harness.Run``: the calls of the window, its length, the
set-up time, the device's memory peak and, in a traced run, the ``Trace``.
"""

from __future__ import annotations

from benchmark import peaks

#: The program's scopes (``utils/profiling.named_scope``) around the device
#: inflate: Phase A, then Phase B with its compact and walk kernels.
INFLATE_SCOPES = ("phase_a_huffman", "phase_b_lz77")


def delivered_MBps(run) -> float | None:
    """Bytes the window's calls delivered to host memory, in MB a second
    of the window."""
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c.out_bytes for c in run.calls) / run.window_s / 1e6


def idle_pct(run) -> float | None:
    """The share of the traced window in which the device ran nothing."""
    t = run.trace
    if t is None or t.window_us <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)


def inflate_roofline(run) -> float | None:
    """The device inflate's share of its bandwidth roofline."""
    if run.trace is None:
        return None
    return peaks.roofline_pct(
        sum(peaks.inflate_bytes(c) for c in run.trace.calls),
        run.trace.device_us_under(INFLATE_SCOPES))


def unfilter_roofline(run) -> float | None:
    """The unfilter kernel's share of its bandwidth roofline."""
    if run.trace is None:
        return None
    return peaks.roofline_pct(
        sum(peaks.unfilter_bytes(c) for c in run.trace.calls),
        run.trace.kernel_us("unfilter"))


def launches_per_MB(run) -> float | None:
    """Kernel launches on the device a MB of decoded output."""
    t = run.trace
    if t is None or not t.kernel_count():
        return None
    mb = sum(c.out_bytes for c in t.calls) / 1e6
    return t.kernel_count() / mb if mb else None
