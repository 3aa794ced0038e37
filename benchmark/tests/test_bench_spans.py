"""The program-span metrics' self-time arithmetic on a small recorded
trace."""

from __future__ import annotations

import pytest

from benchmark import harness, inputs, spans
from benchmark.trace import Trace


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": {}}


def _span(name, ts, dur, tid=1):
    return _x("user_annotation", name, ts, dur, tid)


def _calls():
    a = inputs.Item(args=None, in_bytes=500_000, out_bytes=2_000_000,
                    inflated_bytes=2_000_000, filtered_bytes=2_000_000,
                    raw_bytes=2_000_000)
    return [a, a]  # 4 MB decoded


def recorded(extra=()):
    """A 1,000 us window.  The main thread (1): one call holding the
    request span and, inside it, parse 10-110 with a chunk's CRC-32 at
    20-50, scan 110-210, plan 210-260, staging 260-300 (pack 262-280, h2d
    280-296), Phase A 300-320, Adler-32 320-330, unfilter 330-340,
    read-back 340-380; a read-back at 950-1100 runs past the window's
    end, a scan at -50 and one at 1100 lie outside it.  A worker thread
    (2): a plan 100-300 with staging 150-250 inside it."""
    ev = [
        _span("bench.window", 0, 1000),
        _span("bench.call", 0, 400),
        _span("dbg.decode_png", 10, 380),
        _span("dbg.parse", 10, 100),
        _span("dbg.check", 20, 30),
        _span("dbg.scan", 110, 100),
        _span("dbg.plan", 210, 50),
        _span("dbg.stage", 260, 40),
        _span("dbg.stage.pack", 262, 18),
        _span("dbg.stage.h2d", 280, 16),
        _span("phase_a_huffman", 300, 20),
        _span("dbg.check", 320, 10),
        _span("dbg.unfilter", 330, 10),
        _span("dbg.readback", 340, 40),
        _span("dbg.readback", 950, 150),
        _span("dbg.scan", -50, 40),
        _span("dbg.scan", 1100, 100),
        _span("dbg.plan", 100, 200, tid=2),
        _span("dbg.stage", 150, 100, tid=2),
        _x("kernel", "phase_a_kernel", 305, 10, tid=7),
        *extra,
    ]
    return Trace(ev, _calls())


def _run(trace):
    return harness.Run(setup_s=1.0, window_s=0.001, calls=_calls(),
                       mem_peak_bytes=0, trace=trace)


def test_self_time_by_layer():
    got = spans.layer_us(recorded())
    # parse 100 less its CRC-32's 30; check 30 + 10, each counted once;
    # staging 40 whole (pack and h2d are its parts) on the main thread and
    # 100 on the worker; plan 50 + the worker's 200 less its staging's
    # 100; read-back 40 + 50 inside the window; the request 380 less its
    # children's 370 (Phase A's 20 among them).
    assert got == {"decode_png": pytest.approx(10), "parse": 70,
                   "check": 40, "scan": 100, "plan": 150, "stage": 140,
                   "unfilter": 10, "readback": 90}


def test_a_child_is_subtracted_from_its_parent():
    assert spans.self_us([(0, 100), (10, 40), (40, 70)]) == [40, 30, 30]
    # Nesting follows the times, not the order given.
    assert spans.self_us([(10, 40), (0, 100)]) == [30, 70]
    # A grandchild is taken from its parent only.
    assert spans.self_us([(0, 100), (10, 60), (20, 30)]) == [50, 40, 10]


def test_threads_are_kept_apart():
    main_only = spans.layer_us(Trace(
        [e for e in recorded().annotations if e["tid"] == 1]
        + [_span("bench.window", 0, 1000)], []))
    both = spans.layer_us(recorded())
    assert both["plan"] - main_only["plan"] == 100
    assert both["stage"] - main_only["stage"] == 100
    assert main_only["scan"] == both["scan"] == 100


@pytest.mark.parametrize("kind", ["gz", "png"])
@pytest.mark.parametrize("layer,us", [
    ("parse", 70), ("scan", 100), ("plan", 150), ("stage", 140),
    ("check", 40), ("readback", 90)])
def test_metric_files(kind, layer, us):
    read = harness.load_metric(f"{layer}_ms_per_MB.{kind}")
    assert read(_run(recorded())) == pytest.approx(us / 1e3 / 4.0)


def test_nothing_to_read():
    read = harness.load_metric("plan_ms_per_MB.gz")
    assert read(harness.Run(1.0, 2.0, [], 0, None)) is None
    # A program that marks no such span (one older than its spans).
    old = Trace([_span("bench.window", 0, 100), _span("bench.call", 0, 90),
                 _x("kernel", "k", 5, 5, tid=7)], _calls())
    assert read(_run(old)) is None
    # A run that drove no device.
    no_device = Trace([e for e in recorded().annotations]
                      + [_span("bench.window", 0, 1000)], _calls())
    assert read(_run(no_device)) is None
    # No decoded bytes.
    assert read(_run(Trace(recorded().annotations + recorded().device_ops
                           + [_span("bench.window", 0, 1000)], []))) is None
