"""The piece-loop microbenchmark of the PyTorch port (debigulator_tpu_torch/
tools/microbench_pb.py) against the reference tool's Pallas kernel
(tools/microbench_pb.py, run in interpret mode), on device="cpu" (the
kernel's plain version).  Bit-exact for every variant but nodma, whose
output is undefined."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from debigulator_tpu.utils import config as ref_config
from debigulator_tpu_torch.ops.archive import lz77_generations as lg
from debigulator_tpu_torch.tools import microbench_pb as mb

TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "microbench_pb.py"
ROWS = 100
N = 4096


@pytest.fixture(scope="module")
def ref_tool():
    """The reference tool, loaded with its compilation cache off: its
    import would otherwise make .jax_cache/ and set a JAX option for the
    rest of the worker."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config.get_config(), "compilation_cache", "")
        spec = importlib.util.spec_from_file_location("ref_microbench_pb",
                                                      TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _pieces(n=N, rows=ROWS, seed=3):
    """v12 pieces as the tool makes them, placed so that every source
    window lies inside the buffer: stores overlap (dst steps by 16, len up
    to 23), sources are recent stores, and some windows meet row 8."""
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    dst = 4352 + (i * 16) % (rows * 128 - 4352 - 256)
    dist = rng.integers(384, 4096, n)
    ln = np.minimum(rng.integers(4, 24, n), 128 - (dst & 127))
    rp = dst & 127
    q = dst - dist - rp
    r = q & 127
    w0 = ((dst >> 7) << 16) | (rp << 8) | (rp + ln)
    w1 = ((q >> 7) << 16) | (r << 8) | (128 - r)
    init = rng.integers(0, 256, (rows, 128))
    return (w0.reshape(-1, 128).astype(np.int32),
            w1.reshape(-1, 128).astype(np.int32), init.astype(np.int32))


def _ref_run(tool, monkeypatch, variant, w0, w1, init, stage_rows):
    monkeypatch.setattr(tool, "N_PIECES", w0.size)  # read at trace time
    f = pl.pallas_call(
        functools.partial(tool._kernel, variant=variant,
                          stage_rows=stage_rows),
        out_shape=jax.ShapeDtypeStruct(init.shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        input_output_aliases={2: 0}, interpret=True)
    return np.asarray(f(jnp.asarray(w0), jnp.asarray(w1), jnp.asarray(init)))


@pytest.mark.parametrize("variant,stage_rows", [
    ("full", 16), ("full", 32), ("unroll2", 16), ("unroll4", 16),
    ("unroll8", 16), ("load_only", 16), ("store_only", 16),
    ("scalar_only", 16), ("scalar_smem", 16), ("noop", 16), ("noop8", 16)])
def test_variant_matches_the_reference_kernel(ref_tool, monkeypatch, variant,
                                              stage_rows):
    w0, w1, init = _pieces()
    want = _ref_run(ref_tool, monkeypatch, variant, w0, w1, init, stage_rows)
    got = mb.microbench(variant, torch.from_numpy(w0), torch.from_numpy(w1),
                        torch.from_numpy(init), stage_rows)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if variant in ("full", "load_only", "store_only", "scalar_only"):
        assert not np.array_equal(want, init)  # the variant wrote something


def test_load_only_chain_through_the_sum_row():
    """Groups whose windows meet row 8 read the sum the group before them
    stored there: the plain version follows that chain back, checked here
    against a group-by-group loop."""
    w0, w1, init = _pieces(n=2048, seed=5)
    a = torch.from_numpy(w0).view(-1).long()
    b = torch.from_numpy(w1).view(-1).long()
    q = (b >> 16) * 128 + ((b >> 8) & 127)
    flat = torch.from_numpy(init).view(-1).long().clone()
    acc = slice(mb.ACC_ROW * 128, mb.ACC_ROW * 128 + 128)
    meets = 0
    for g in range(0, a.numel(), mb.GROUP):
        rows = [flat[q[g + k] : q[g + k] + 128] for k in range(mb.GROUP)]
        meets += any(q[g + k] + 128 > acc.start and q[g + k] < acc.stop
                     for k in range(mb.GROUP))
        flat[acc] = sum(rows)
    assert meets > 0
    want = mb._wrap32(flat[acc])
    got = mb.microbench_plain("load_only", torch.from_numpy(w0),
                              torch.from_numpy(w1), torch.from_numpy(init))
    assert torch.equal(got.view(-1)[acc], want)


def test_make_pieces_is_the_reference_tools(ref_tool, monkeypatch):
    """make_pieces against the arrays the reference's main() builds (its
    first run is caught before it times anything)."""
    seen = {}

    class Stop(Exception):
        pass

    def catch(variant, w0, w1, init, stage_rows=16):
        seen.update(w0=np.asarray(w0), w1=np.asarray(w1), init=np.asarray(init))
        raise Stop

    assert mb.N_PIECES == ref_tool.N_PIECES
    monkeypatch.setattr(ref_tool, "N_PIECES", 8192)
    monkeypatch.setattr(ref_tool, "run_variant", catch)
    with pytest.raises(Stop):
        ref_tool.main()
    w0, w1 = mb.make_pieces(8192)
    assert np.array_equal(w0, seen["w0"]) and np.array_equal(w1, seen["w1"])
    assert seen["init"].shape == (mb.ROWS, 128)
    assert (mb.ROWS, mb.GROUP, mb.STAGE_ROWS) == (
        ref_tool.ROWS, ref_tool.GROUP, ref_tool.STAGE_ROWS)


def test_nodma_has_no_plain_version():
    w0, w1, init = (torch.from_numpy(a) for a in _pieces(n=2048))
    with pytest.raises(ValueError, match="undefined"):
        mb.microbench("nodma", w0, w1, init)
    with pytest.raises(ValueError, match="unknown"):
        mb.microbench("unroll3", w0, w1, init)


@pytest.mark.parametrize("variant", ["full", "noop8", "nodma"])
def test_card_branch_counts_its_launch(monkeypatch, variant):
    """The card's branch, taken here on CPU tensors with the launch
    recorded instead of made: the packing is checked, one launch per call
    with a whole stage, none without."""
    from debigulator_tpu_torch.ops import _kernels

    made = []
    monkeypatch.setattr(lg, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch", lambda entry, *a: made.append(a))
    w0, w1, init = (torch.from_numpy(a) for a in _pieces(n=4096))
    before = mb.microbench.launches
    mb.microbench(variant, w0, w1, init, 16)
    mb.microbench(variant, w0[:8], w1[:8], init, 16)  # no whole stage
    assert mb.microbench.launches == before + 1 and len(made) == 1
    code, unroll = mb.VARIANTS[variant]
    assert made[0][4:] == (2, 16, code, unroll)
    bad = w1.clone()
    bad.view(-1)[5] ^= 1  # low byte no longer 128 - r
    with pytest.raises(ValueError, match="packing"):
        mb.microbench(variant, w0, bad, init, 16)
