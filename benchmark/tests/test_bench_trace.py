"""The per-layer metrics' arithmetic on a small recorded trace."""

from __future__ import annotations

import pytest

from benchmark import harness, inputs, peaks
from benchmark.trace import Trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _calls():
    a = inputs.Item(args=None, in_bytes=1_000_000, out_bytes=4_000_000,
                    inflated_bytes=4_000_000, filtered_bytes=4_000_000,
                    raw_bytes=3_990_000)
    return [a, a]


def recorded():
    """Two calls in a 1,000 us window.  Call 1 (0-400 us): plan 0-100,
    prepare 100-150, Phase A 150-200 (one kernel of 20 us), Phase B
    200-300 (two kernels, 30 + 10 us, and a memset of 5), a copy out of 40
    at 300-340 outside the scopes.  Call 2 (500-900 us): one unfilter
    kernel of 25 us inside the Phase B scope, nothing else."""
    ev = [
        _x("user_annotation", "bench.window", 0, 1000),
        _x("user_annotation", "bench.call", 0, 400),
        _x("user_annotation", "bench.plan", 0, 100),
        _x("user_annotation", "bench.prepare", 100, 50),
        _x("user_annotation", "phase_a_huffman", 150, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 160, 5, correlation=1),
        _x("user_annotation", "phase_b_lz77", 200, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 220, 5, correlation=3),
        _x("cuda_runtime", "cudaMemsetAsync", 230, 2, correlation=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 305, 3, correlation=5),
        _x("user_annotation", "bench.call", 500, 400),
        _x("user_annotation", "bench.plan", 500, 200),
        _x("user_annotation", "bench.prepare", 700, 100),
        _x("user_annotation", "phase_b_lz77", 800, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 805, 5, correlation=6),
        # device side (pid 0, stream 7)
        _x("kernel", "phase_a_kernel", 170, 20, tid=7, correlation=1),
        _x("kernel", "chase_kernel", 230, 30, tid=7, correlation=2),
        _x("kernel", "run_kernel", 260, 10, tid=7, correlation=3),
        _x("gpu_memset", "Memset (Device)", 270, 5, tid=7, correlation=4),
        _x("gpu_memcpy", "Memcpy DtoH", 310, 40, tid=7, correlation=5),
        _x("kernel", "unfilter_band_kernel<4>", 820, 25, tid=7,
           correlation=6),
    ]
    return Trace(ev, _calls())


def _run(trace):
    return harness.Run(setup_s=1.0, window_s=0.001, calls=trace.calls,
                       mem_peak_bytes=0, trace=trace)


def test_busy_and_gaps():
    t = recorded()
    # 170-190, 230-275, 310-350, 820-845
    assert t.busy_us() == pytest.approx(20 + 45 + 40 + 25)
    assert t.window_us == 1000
    gaps = t.gaps()
    assert gaps[0] == (0, 170) and gaps[-1] == (845, 1000)
    assert sum(e - s for s, e in gaps) == pytest.approx(1000 - 130)


def test_idle_by_scope():
    rows = dict(recorded().idle_by_scope())
    # plan 0-100 and 500-700; prepare 100-150 and 700-800; Phase A
    # 150-170 and 190-200; Phase B 200-230, 275-300, 800-820, 845-850;
    # the rest of call 1 (300-310, 350-400) and of call 2 (850-900);
    # outside any call 400-500 and 900-1000.
    assert rows["bench.plan"] == pytest.approx(300e-6)
    assert rows["bench.prepare"] == pytest.approx(150e-6)
    assert rows["phase_a_huffman"] == pytest.approx(30e-6)
    assert rows["phase_b_lz77"] == pytest.approx(80e-6)
    assert rows["bench.call"] == pytest.approx(110e-6)
    assert rows["outside_spans"] == pytest.approx(200e-6)
    assert sum(rows.values()) == pytest.approx(870e-6)


def test_device_ops_by_name():
    rows = recorded().device_ops_by_name()
    assert rows[0] == ["Memcpy DtoH", pytest.approx(40e-6)]
    assert len(rows) == 6


def test_layer_metrics():
    t = recorded()
    run = _run(t)
    read = harness.load_metric
    assert read("device_idle_pct.gz")(run) == pytest.approx(87.0)
    assert read("device_idle_pct.png")(run) == pytest.approx(87.0)
    assert read("launches_per_MB.gz")(run) == pytest.approx(4 / 8.0)
    # Inflate: Phase A 20 + Phase B 30 + 10 + 5 (call 1) + 25 (call 2).
    inflate = 2 * 5_000_000 / peaks.HBM_BYTES_PER_S / 90e-6 * 100
    assert read("inflate_roofline_pct.gz")(run) == pytest.approx(inflate)
    assert read("inflate_roofline_pct.png")(run) == pytest.approx(inflate)
    unf = 2 * 7_990_000 / peaks.HBM_BYTES_PER_S / 25e-6 * 100
    assert read("unfilter_roofline_pct.png")(run) == pytest.approx(unf)


def test_untraced_and_empty_runs_read_nothing():
    empty = Trace([_x("user_annotation", "bench.window", 0, 100)], [])
    for name in ("inflate_roofline_pct.gz",
                 "launches_per_MB.gz", "device_idle_pct.gz",
                 "unfilter_roofline_pct.png"):
        assert harness.load_metric(name)(_run(empty)) is None
        untraced = harness.Run(1.0, 2.0, [], 0, None)
        assert harness.load_metric(name)(untraced) is None


def test_end_to_end_arithmetic():
    calls = _calls()
    run = harness.Run(setup_s=12.5, window_s=2.0, calls=calls,
                      mem_peak_bytes=1_500_000_000)
    assert harness.load_metric("gz_out_MBps")(run) == pytest.approx(4.0)
    assert harness.load_metric("png_rgba_MBps")(run) == pytest.approx(4.0)
    assert harness.load_metric("mem_peak_GB")(run) == pytest.approx(1.5)
    assert harness.load_metric("setup_s")(run) == 12.5
