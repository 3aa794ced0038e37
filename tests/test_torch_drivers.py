"""The decode drivers of the PyTorch port (inflate_v3/v4/v5/v7/v13 and the
selection in inflate_device) against the JAX package's jitted drivers
(Pallas kernels in interpret mode) and zlib, on device="cpu" (the kernels'
plain versions).  Bit-exact everywhere."""

import zlib

import numpy as np
import pytest
import torch

from debigulator_tpu.ops import inflate_v3 as v3
from debigulator_tpu.ops import lz77_pallas as lz
from debigulator_tpu.ops.phase_a_pallas import build_pa_arrays
from debigulator_tpu.ops.scanner import scan_stream_cells
from debigulator_tpu.parallel.merged import build_merged_plan
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import phase_a as tpa
from debigulator_tpu_torch.ops import plan as tp
from debigulator_tpu_torch.tools import profile_r3
from debigulator_tpu_torch.tools.inputs import make_streams, obj_text
from torch_stream_cases import (
    STREAMS,
    deflate,
    ensure_reference_native,
    to_port_arrays,
    to_port_plan,
    words,
)


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


CPU = torch.device("cpu")
#: (stream, exact entries) for the tensor-op drivers; "dense" overflows 16
#: slots, so the overflow flag is compared and its body skipped.
GRAPH_CASES = [("dynamic", True), ("dynamic", False), ("mixed", False),
               ("rle", True), ("flushed", False), ("dense", False)]
IDS = [f"{n}-{'exact' if e else 'speculative'}" for n, e in GRAPH_CASES]


def _ref_plan(name, exact=True):
    stream = STREAMS[name]()
    blocks, lengths, cells = scan_stream_cells(stream, v3.CELL_BITS)
    plan = v3.build_plan_v3(stream, blocks, lengths,
                            cells=cells if exact else None)
    return plan, zlib.decompress(stream, -15)


def _n_seg(plan):
    return v3._round_pow2(max(1, -(-plan.out_size // v3.SEG_BYTES)), 1)


def _bytes(t, n):
    return t[:n].to(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("name,exact", GRAPH_CASES, ids=IDS)
def test_inflate_v3(name, exact):
    plan, data = _ref_plan(name, exact)
    ref_arrays = v3.plan_arrays_v3(plan)
    out_pad = v3._round_pow2(max(plan.out_size, 1), 256)
    want, want_of, want_sweeps = v3._inflate_v3_jit(
        ref_arrays, plan.n_bits, plan.slots, out_pad, exact=exact)
    got, overflow, sweeps = inf.inflate_v3(
        to_port_arrays(ref_arrays), plan.n_bits, plan.slots, out_pad,
        exact=exact)
    assert bool(overflow) == bool(want_of) == (name == "dense")
    assert sweeps <= int(want_sweeps) and (sweeps > 0) == (not exact)
    if not bool(overflow):
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert got[: plan.out_size].numpy().tobytes() == data


@pytest.mark.parametrize("name,exact", GRAPH_CASES, ids=IDS)
def test_inflate_v4(name, exact):
    plan, data = _ref_plan(name, exact)
    ref_arrays = v3.plan_arrays_v3(plan)
    out_rows = v3._round_pow2(
        -(-(plan.out_size + lz.PAD + lz.WINDOW + lz.MAXLEN + 512) // 128), 64)
    m_rows = v3._round_pow2(-(-(plan.out_size // 3 + 130) // 128), 16)
    want, want_of = v3._inflate_v4_jit(
        ref_arrays, plan.n_bits, plan.slots, out_rows, m_rows, exact=exact,
        interpret=True)
    got, overflow = inf.inflate_v4(to_port_arrays(ref_arrays), plan.n_bits,
                                   plan.slots, out_rows, m_rows, exact=exact)
    assert bool(overflow) == bool(want_of) == (name == "dense")
    if not bool(overflow):
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert _bytes(got.view(-1)[lz.PAD + lz.WINDOW:], plan.out_size) == data


@pytest.mark.parametrize("name,exact", GRAPH_CASES, ids=IDS)
def test_inflate_v5(name, exact):
    plan, data = _ref_plan(name, exact)
    ref_arrays = v3.plan_arrays_v3(plan)
    want, want_of = v3._inflate_v5_jit(
        ref_arrays, plan.n_bits, plan.slots, _n_seg(plan), exact=exact,
        interpret=True)
    got, overflow = inf.inflate_v5(to_port_arrays(ref_arrays), plan.n_bits,
                                   plan.slots, _n_seg(plan), exact=exact)
    assert bool(overflow) == bool(want_of) == (name == "dense")
    if not bool(overflow):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert _bytes(got, plan.out_size) == data


def _staged(plan):
    port = to_port_plan(plan)
    pa = tpa.stage_phase_a_inputs(tpa.build_phase_a_inputs(port), CPU)
    return port, pa, tp.plan_arrays_v7(port, CPU)


@pytest.mark.parametrize("name", ["dynamic", "mixed", "rle"])
def test_inflate_v7(name):
    plan, data = _ref_plan(name)
    ref_pa = build_pa_arrays(plan)
    # The reference's v7 reads bob_cell from the arrays it is given, which
    # its own plan_arrays_v7 does not hold: hand it plan_arrays_v3.
    want, want_of = v3._inflate_v7_jit(
        ref_pa, v3.plan_arrays_v3(plan), plan.slots, _n_seg(plan),
        plan.num_cells, interpret=True)
    port, pa, arrays = _staged(plan)
    got, overflow = inf.inflate_v7(pa, arrays, port.slots, _n_seg(plan),
                                   port.num_cells)
    assert not bool(overflow) and not bool(want_of)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert _bytes(got, plan.out_size) == data


def _v13_case(name):
    """(reference plan, the port's staged v13 inputs and slots, decoded
    bytes): a stream of STREAMS staged from the reference's plan, or
    "profile_r3", tools/profile_r3's batch (two copies of a 20,000-byte
    OBJ-text stream) as that tool plans and stages it."""
    if name != "profile_r3":
        plan, data = _ref_plan(name)
        port, pa, arrays = _staged(plan)
        return plan, pa, arrays, port.slots, data
    text = obj_text(size=20_000)
    streams = make_streams(text, 1) * 2
    mp, pa, arrays, _, _ = profile_r3.stage(streams, CPU)
    plan = build_merged_plan(streams, records=False).plan
    return plan, pa, arrays, mp.plan.slots, text * 2


@pytest.mark.parametrize("name", ["dynamic", "mixed", "rle", "profile_r3"])
def test_inflate_v13(name):
    plan, pa, arrays, slots, data = _v13_case(name)
    ref_pa = build_pa_arrays(plan)
    want, want_of = v3._inflate_v13_jit(
        ref_pa, v3.plan_arrays_v7(plan), plan.slots, _n_seg(plan),
        interpret=True)
    got, overflow = inf.inflate_v13(pa, arrays, slots, _n_seg(plan))
    assert not bool(overflow) and not bool(want_of)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert _bytes(got, plan.out_size) == data


def test_v7_and_v13_flag_overflow_below_the_exact_slots():
    plan, _ = _ref_plan("dense")
    port, pa, arrays = _staged(plan)
    assert port.slots == 32
    assert bool(inf.inflate_v7(pa, arrays, 16, 1, port.num_cells)[1])
    assert bool(inf.inflate_v13(pa, arrays, 16, 1)[1])
    assert not bool(inf.inflate_v13(pa, arrays, 32, 1)[1])


@pytest.fixture(scope="module")
def big():
    """A stream of more than one 512 KiB segment, with matches across the
    segment edge."""
    data = words(150_000, seed=6)
    assert len(data) > tp.SEG_BYTES
    return deflate(data, 9), data


@pytest.mark.parametrize("driver", ["v5", "v13", "v7"])
def test_multi_segment(driver, big):
    from debigulator_tpu_torch.ops.scanner import scan_stream_cells as scan

    stream, data = big
    blocks, lengths, cells = scan(stream, tp.CELL_BITS)
    plan = tp.build_plan_v3(stream, blocks, lengths, cells=cells)
    if driver == "v5":
        # Exact entries: this five-word text never resynchronises, so its
        # speculative fixpoint takes one sweep per cell (8406 of them).
        body, overflow = inf.inflate_v5(tp.plan_arrays_v3(plan, CPU),
                                        plan.n_bits, plan.slots, 2, exact=True)
    else:
        pa = tpa.stage_phase_a_inputs(tpa.build_phase_a_inputs(plan), CPU)
        arrays = tp.plan_arrays_v7(plan, CPU)
        if driver == "v13":
            body, overflow = inf.inflate_v13(pa, arrays, plan.slots, 2)
        else:
            body, overflow = inf.inflate_v7(pa, arrays, plan.slots, 2,
                                            plan.num_cells)
    assert not bool(overflow) and body.numel() == 2 * tp.SEG_BYTES
    assert _bytes(body, plan.out_size) == data


# ---------------------------------------------------------------------------
# Selection in inflate_device
# ---------------------------------------------------------------------------


def _spy(monkeypatch, *names):
    calls = []
    for n in names:
        real = getattr(inf, n)
        monkeypatch.setattr(
            inf, n, lambda *a, _n=n, _r=real, **k: calls.append(_n) or _r(*a, **k))
    return calls


ALL = ("flagship_body", "inflate_v3", "inflate_v4", "inflate_v5", "inflate_v13")


def test_default_is_the_flagship(monkeypatch):
    calls = _spy(monkeypatch, *ALL)
    stream = STREAMS["mixed"]()
    assert inf.inflate_device(stream, device="cpu") == zlib.decompress(stream, -15)
    assert calls == ["flagship_body"]


def test_phase_b_v13_selects_the_op_driver(monkeypatch):
    monkeypatch.setenv("DBG_PHASE_B", "v13")
    calls = _spy(monkeypatch, *ALL)
    stream = STREAMS["mixed"]()
    got = inf.inflate_device(stream, device="cpu")
    assert calls == ["inflate_v13"]
    assert got == zlib.decompress(stream, -15)
    assert got == v3.inflate_device_v3(stream, force_pallas=True)


@pytest.mark.parametrize("name", ["dynamic", "mixed", "flushed", "stored"])
def test_no_native_selects_v4(monkeypatch, name):
    """DBG_NO_NATIVE=1: the Python scan gives no cell entries, the plan is
    speculative, and a body under OUT_CAP goes through v4."""
    stream = STREAMS[name]()
    blocks, lengths, _ = scan_stream_cells(stream, v3.CELL_BITS)
    want = v3.inflate_device_v3(stream, force_pallas=True,
                                scanned=(blocks, lengths, None))
    monkeypatch.setenv("DBG_NO_NATIVE", "1")
    calls = _spy(monkeypatch, *ALL)
    got = inf.inflate_device(stream, device="cpu")
    assert calls == ([] if name == "stored" else ["inflate_v4"])
    assert got == want == zlib.decompress(stream, -15)


def test_no_native_selects_v5_above_out_cap(monkeypatch):
    """OUT_CAP (1.5 MiB) is only the threshold between v4 and v5; lowered
    here so that a 16 KB body is "large"."""
    stream = STREAMS["mixed"]()
    data = zlib.decompress(stream, -15)
    monkeypatch.setattr(inf.lz, "OUT_CAP", len(data) + 511)
    monkeypatch.setenv("DBG_NO_NATIVE", "1")
    calls = _spy(monkeypatch, *ALL)
    assert inf.inflate_device(stream, device="cpu") == data
    assert calls == ["inflate_v5"]
    monkeypatch.setattr(inf.lz, "OUT_CAP", len(data) + 512)
    assert inf.inflate_device(stream, device="cpu") == data
    assert calls == ["inflate_v5", "inflate_v4"]


def test_overflow_retries_at_cell_bits(monkeypatch):
    """The dense stream overflows 16 slots: v4 and v3 run twice, the second
    time at CELL_BITS slots, and the bytes come out right."""
    stream = STREAMS["dense"]()
    data = zlib.decompress(stream, -15)
    monkeypatch.setenv("DBG_NO_NATIVE", "1")
    calls = _spy(monkeypatch, *ALL)
    assert inf.inflate_device(stream, device="cpu") == data
    assert inf.inflate_device(stream, device="cpu", use_kernels=False) == data
    assert calls == ["inflate_v4", "inflate_v4", "inflate_v3", "inflate_v3"]


def test_kernels_off_selects_v3(monkeypatch):
    calls = _spy(monkeypatch, *ALL)
    stream = STREAMS["mixed"]()
    got = inf.inflate_device(stream, device="cpu", use_kernels=False)
    assert calls == ["inflate_v3"]
    assert got == v3.inflate_device_v3(stream, force_pallas=False)
    assert got == zlib.decompress(stream, -15)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        inf.inflate_device(STREAMS["dynamic"]())
