"""The batch layer and the mesh of the PyTorch port (stacked plans, the
tensor-op v3 core a stream at a time, the dp split over a mesh of repeated
CPU devices, the ring tail exchange) against the JAX package and zlib, on
device="cpu".  Inputs are tests/test_parallel.py's."""

import zlib

import numpy as np
import pytest
import torch

from debigulator_tpu.parallel import batch as ref_pb
from debigulator_tpu_torch.parallel import batch as pb
from debigulator_tpu_torch.parallel.mesh import (
    dp_sharding,
    make_mesh,
    replicated,
)
from torch_stream_cases import ensure_reference_native


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


def _raw(data: bytes, level=6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def _mk_streams(n, seed=0):
    rng = np.random.default_rng(seed)
    datas, streams = [], []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            d = rng.integers(0, 256, int(rng.integers(100, 3000)),
                             dtype=np.uint8).tobytes()
        elif kind == 1:
            d = b"repetitive content " * int(rng.integers(10, 200))
        else:
            d = bytes(range(256)) * int(rng.integers(1, 20))
        datas.append(d)
        streams.append(_raw(d, level=int(rng.integers(1, 10))))
    return datas, streams


def test_stack_plans_equals_reference():
    _, streams = _mk_streams(5)
    got, got_dims = pb.stack_plans(pb.plan_streams(streams))
    want, want_dims = ref_pb.stack_plans(ref_pb.plan_streams(streams))
    assert got_dims == want_dims
    assert list(got) == list(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.dtype == w.dtype and np.array_equal(v, w), k


def test_batched_inflate_single_device():
    datas, streams = _mk_streams(5)
    assert pb.decode_batch_device(streams, device="cpu") == datas


def test_sharded_inflate_dp8():
    mesh = make_mesh(dp=8, devices=["cpu"] * 8)
    datas, streams = _mk_streams(16, seed=1)
    assert pb.decode_batch_device(streams, mesh=mesh) == datas


def test_sharded_inflate_uneven_batch():
    mesh = make_mesh(dp=8, devices=["cpu"] * 8)
    datas, streams = _mk_streams(5, seed=2)  # padded to 8 internally
    assert pb.decode_batch_device(streams, mesh=mesh) == datas
    batched, dims = pb.stack_plans(pb.plan_streams(streams))
    with pytest.raises(ValueError, match="divisible"):
        pb.sharded_inflate(mesh, batched, dims)


@pytest.mark.parametrize("mesh", [None, "dp2"])
def test_tape_overflow_retries_at_cell_bits(monkeypatch, mesh):
    """Two slots overflow every dense cell: the batch decodes once more at
    CELL_BITS slots, and the bytes are zlib's."""
    datas, streams = _mk_streams(5, seed=3)
    seen = []
    real = pb.batched_inflate

    def spy(batched, n_bits, slots, out_size):
        out, overflow = real(batched, n_bits, slots, out_size)
        seen.append((slots, bool(overflow.any())))
        return out, overflow

    monkeypatch.setattr(pb, "batched_inflate", spy)
    m = make_mesh(dp=2, devices=["cpu"] * 2) if mesh else None
    assert pb.decode_batch_device(streams, mesh=m, slots=2, device="cpu") \
        == datas
    parts = 1 if m is None else 2
    assert seen == [(2, True)] * parts + [(pb.pl.CELL_BITS, False)] * parts


def test_ring_tail_exchange_semantics():
    """Shard i > 0 receives shard i-1's last `tail` elements on its own
    device; shard 0 receives zeros."""
    n, tail = 64, 4
    xs = [torch.arange(i * n, (i + 1) * n, dtype=torch.int32) for i in range(8)]
    got = pb.ring_tail_exchange(xs, tail)
    assert torch.equal(got[0], torch.zeros(tail, dtype=torch.int32))
    for i in range(1, 8):
        assert torch.equal(got[i], torch.arange(i * n - tail, i * n,
                                                dtype=torch.int32))
        assert got[i].device == xs[i].device


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(dp=2, sp=4, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert mesh.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    assert make_mesh(sp=2, devices=["cpu"] * 8).shape == {"dp": 4, "sp": 2}
    assert dp_sharding(mesh) == [torch.device("cpu")] * 2
    assert replicated(mesh) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="device count"):
        make_mesh(dp=3, sp=2, devices=["cpu"] * 8)
