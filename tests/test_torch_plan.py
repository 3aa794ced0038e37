"""Host scan and plan of the PyTorch port against the JAX package: the
native scan's outputs and every PlanV3 field must be equal, for single
streams and merged batches (bit-exact, tolerance 0)."""

import dataclasses
import zlib

import numpy as np
import pytest

from debigulator_tpu.ops import inflate_v3 as v3
from debigulator_tpu.ops.scanner import scan_stream_cells as ref_scan
from debigulator_tpu.parallel import merged as ref_merged
from debigulator_tpu_torch.ops import plan as tp
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
from debigulator_tpu_torch.parallel import merged as tm
from torch_stream_cases import ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


def _deflate(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(data) + c.flush()


def _text(n_words: int, seed: int = 3) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"\n"]
    return b"".join(words[int(v) % 5] for v in rng.integers(0, 5, n_words))


def _flush_heavy_fixed():
    piece = b"flush-heavy block content of 66 bytes padding padding paddingXY\n"
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    parts = []
    for _ in range(300):
        parts.append(c.compress(piece))
        parts.append(c.flush(zlib.Z_PARTIAL_FLUSH))
    parts.append(c.flush())
    return b"".join(parts)


def _stored_mix():
    rng = np.random.default_rng(13)
    t1 = _text(4000, seed=1)
    mid = rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    st = c.compress(t1) + c.flush(zlib.Z_FULL_FLUSH)
    c0 = zlib.compressobj(0, zlib.DEFLATED, -15)
    st += c0.compress(mid) + c0.flush(zlib.Z_FULL_FLUSH)
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    st += c.compress(t1[::-1]) + c.flush()
    return st


STREAMS = {
    "level0": lambda: _deflate(_text(20_000), 0),
    "level1": lambda: _deflate(_text(20_000), 1),
    "level6": lambda: _deflate(_text(20_000), 6),
    "level9": lambda: _deflate(_text(20_000), 9),
    "fixed": lambda: _deflate(_text(20_000), 6, zlib.Z_FIXED),
    "flush_heavy_fixed": _flush_heavy_fixed,
    "stored_mix": _stored_mix,
}


def assert_plans_equal(ref, got):
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_scan_matches_reference(name):
    stream = STREAMS[name]()
    rb, rl, rc = ref_scan(stream, v3.CELL_BITS)
    gb, gl, gc = scan_stream_cells(stream, tp.CELL_BITS)
    assert [dataclasses.astuple(b) for b in rb] == \
        [dataclasses.astuple(b) for b in gb]
    assert len(rl) == len(gl)
    for a, b in zip(rl, gl):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert np.array_equal(rc[0], gc[0]) and np.array_equal(rc[1], gc[1])
    assert rc[2] == gc[2]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_plan_matches_reference(name):
    stream = STREAMS[name]()
    blocks, lengths, cells = scan_stream_cells(stream, tp.CELL_BITS)
    got = tp.build_plan_v3(stream, blocks, lengths, cells=cells)
    ref = v3.build_plan_v3(stream, *ref_scan(stream, v3.CELL_BITS)[:2],
                           cells=ref_scan(stream, v3.CELL_BITS)[2])
    assert_plans_equal(ref, got)
    assert tp.v15_stream_too_large(got) == v3.v15_stream_too_large(ref)
    if name == "flush_heavy_fixed":
        assert got.used_bits > 8 * len(stream)  # the hazardous shape


def test_plan_from_numpy_round_trip():
    stream = STREAMS["stored_mix"]()
    ref = v3.build_plan_v3(stream, *ref_scan(stream, v3.CELL_BITS)[:2],
                           cells=ref_scan(stream, v3.CELL_BITS)[2])
    assert_plans_equal(ref, tp.plan_from_numpy(dataclasses.asdict(ref)))


def test_merged_plan_matches_reference():
    streams = [STREAMS["level1"](), STREAMS["stored_mix"](),
               STREAMS["flush_heavy_fixed"]()]
    ref = ref_merged.build_merged_plan(streams, records=False)
    got = tm.build_merged_plan(streams)
    assert_plans_equal(ref.plan, got.plan)
    assert ref.out_offsets == got.out_offsets
    assert ref.out_sizes == got.out_sizes


def test_phase_a_inputs_keep_cells_and_offsets():
    """The port's Phase A inputs: tile-padded to TC cells, block ids in
    range, and padding cells repeat the last stored-bytes offset (the
    glue's cbase must stay monotone)."""
    from debigulator_tpu_torch.ops.phase_a import build_phase_a_inputs

    stream = STREAMS["stored_mix"]()
    blocks, lengths, cells = scan_stream_cells(stream, tp.CELL_BITS)
    plan = tp.build_plan_v3(stream, blocks, lengths, cells=cells)
    inp = build_phase_a_inputs(plan)
    assert inp["cellw"].shape[1] % tp.TC == 0
    bob = inp["bob_cell"].astype(np.int64)
    assert (np.diff(bob) >= 0).all()
    assert bob[-1] == bob[plan.num_cells - 1]
    assert inp["cell_block"].max() < plan.ll_count.shape[0]
