"""The split-stream decode of the PyTorch port (native taint analysis,
per-shard record plans, phase 1 and the patch rounds of the walk) against
the JAX package and zlib, on device="cpu" (the walk's plain version).
Bit-exact everywhere.  Inputs are made with zlib from numpy seeds, like
tests/test_split_stream.py's."""

import zlib

import numpy as np
import pytest
import torch

from debigulator_tpu.native import scanner as ref_scanner
from debigulator_tpu.parallel import split_stream as ref_ss
from debigulator_tpu.parallel.merged import build_merged_plan as ref_merged_plan
from debigulator_tpu_torch.native import scanner as tns
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops import phase_b as tpb
from debigulator_tpu_torch.parallel import split_stream as ss
from debigulator_tpu_torch.parallel.mesh import make_mesh
from torch_stream_cases import deflate, ensure_reference_native

SEG = 32768  # the least seg_bytes: one DEFLATE window


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native scan loaded (see ensure_reference_native)."""
    ensure_reference_native()


def _textish(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"lazy", b"dog",
             b"deflate", b"huffman", b"window", b"shard", b"tail"]
    out, total = [], 0
    while total < n:
        w = words[int(rng.integers(len(words)))]
        out.append(w + b" ")
        total += len(w) + 1
    return b"".join(out)[:n]


def _stored_at_boundaries():
    """Compressed, stored (level 0) and compressed chunks across the shard
    bounds of three shards."""
    parts = [_textish(40_000, seed=1), b"\x00" * 30_000, _textish(40_000, 2)]
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    stream = c.compress(parts[0]) + c.flush(zlib.Z_FULL_FLUSH)
    c0 = zlib.compressobj(0, zlib.DEFLATED, -15)
    stream += c0.compress(parts[1]) + c0.flush(zlib.Z_FULL_FLUSH)
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    return stream + c.compress(parts[2]) + c.flush()


def _random(n: int = 150_000) -> bytes:
    return np.random.default_rng(7).integers(0, 256, n, dtype=np.uint8).tobytes()


#: name -> (stream, shards).
CASES = {
    "text_2": (lambda: deflate(_textish(100_000)), 2),
    "text_4": (lambda: deflate(_textish(150_000)), 4),
    "rle_3": (lambda: deflate(b"ab" * 60_000), 3),
    "random_4": (lambda: deflate(_random()), 4),
    "more_shards_than_output_6": (lambda: deflate(_textish(100_000)), 6),
    "stored_3": (_stored_at_boundaries, 3),
}


def _split_matches(stream: bytes, n_shards: int):
    """The reference's matches of `stream` split at the shard bounds, as
    plan_split_stream hands them to the taint analysis."""
    mp = ref_merged_plan([stream])
    out_size, recs = mp.plan.out_size, mp.recs
    shard = -(-(-(-out_size // n_shards)) // SEG) * SEG
    m_len = (recs["m_meta"].astype(np.int64) >> 16) & 0xFFFF
    mi, pos, ln, _ = ss._split_at(recs["m_pos"].astype(np.int64), m_len,
                                  lambda p: (p // shard + 1) * shard)
    meta = (ln << 16) | (recs["m_meta"].astype(np.int64)[mi] & 0xFFFF)
    return pos.astype(np.int32), meta.astype(np.int32), out_size, shard


@pytest.mark.parametrize("name", ["text_2", "rle_3",
                                  "more_shards_than_output_6"])
def test_taint_matches_equals_reference(name):
    make, n = CASES[name]
    pos, meta, out_size, shard = _split_matches(make(), n)
    got = tns.taint_matches(pos, meta, out_size, shard, n_shards=n)
    want = ref_scanner.taint_matches(pos, meta, out_size, shard, n_shards=n)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[1]) == n


@pytest.mark.parametrize("name", list(CASES))
def test_plan_split_stream_equals_reference(name):
    """shard_bytes, n_seg, rounds, each shard's stored-byte init, literal
    runs and match count (phase 1 and patch), and the literal bytes are
    the reference's."""
    make, n = CASES[name]
    stream = make()
    got = ss.plan_split_stream(stream, n, seg_bytes=SEG)
    want = ref_ss.plan_split_stream(stream, n, seg_bytes=SEG)
    for f in ("n_shards", "shard_bytes", "n_seg", "seg_bytes", "out_size",
              "rounds"):
        assert getattr(got, f) == getattr(want, f), f
    lit = np.asarray(want.lit).reshape(-1)
    assert np.array_equal(got.lit, lit[: len(got.lit)])
    assert not lit[len(got.lit):].any()
    for s in range(n):
        p1 = got.phase1[s]
        init = tpb.init_body(got.n_seg, torch.from_numpy(p1["stored_pos"]),
                             torch.from_numpy(p1["stored_val"]),
                             seg_bytes=SEG)[tpb.WINDOW:]
        assert np.array_equal(init.numpy(),
                              np.asarray(want.phase1["init"][s]).reshape(-1))
        for key in ("rdst", "rmeta"):
            ref = np.asarray(want.phase1[key][s]).reshape(-1)
            k = len(p1[key])
            assert np.array_equal(p1[key], ref[:k]) and not ref[k:].any()
        for mine, ref in ((p1, want.phase1), (got.patch[s], want.patch)):
            # The reference's lims[:, 3]: matches before each segment's end.
            n_m = int(np.asarray(ref["lims"][s])[-1, 3])
            assert len(mine["mdst"]) == n_m
            w0 = np.asarray(ref["mw0"][s]).reshape(-1)[:n_m]
            assert np.array_equal(mine["mdst"] & 127, (w0 >> 9) & 0x7F)
            assert np.array_equal((mine["mmeta"] >> 16) & 0x1FF, w0 & 0x1FF)
    if name == "rle_3":
        assert got.rounds >= 2
    if name == "random_4":
        assert got.rounds <= 1


def test_shards_equal_the_jax_walk_round_by_round():
    """Every shard's body after phase 1 and after each patch round equals
    the reference's run_records_v15 (the Pallas walk, interpret mode) on
    its own plan, with its own tails."""
    import jax.numpy as jnp

    stream = deflate(_textish(70_000, seed=5))
    plan = ss.plan_split_stream(stream, 2, seg_bytes=SEG)
    ref = ref_ss.plan_split_stream(stream, 2, seg_bytes=SEG)
    assert plan.rounds == ref.rounds >= 1
    lit = jnp.asarray(ref.lit)
    staged = ss.stage_split(plan, [torch.device("cpu")] * 2)

    def ref_run(d, s, **k):
        arrs = ref_ss._shard_arrays(d, s, lit)
        return np.asarray(ref_ss.run_records_v15(arrs, SEG, interpret=True,
                                                 **k))

    outs = ss.phase1(staged)
    want = [ref_run(ref.phase1, s) for s in range(2)]
    for r in range(plan.rounds + 1):
        for g, w in zip(outs, want, strict=True):
            assert np.array_equal(g.numpy(), w), f"round {r}"
        if r == plan.rounds:
            break
        tails = [torch.zeros(tpb.WINDOW, dtype=torch.int32), outs[0][-tpb.WINDOW:]]
        outs = ss.patch_round(staged, outs, tails)
        zero = jnp.zeros((tpb.WINDOW // 128, 128), jnp.int32)
        want = [ref_run(ref.patch, s,
                        tail0=zero if s == 0 else jnp.asarray(
                            want[s - 1][-tpb.WINDOW:].reshape(-1, 128)),
                        body_init=jnp.asarray(want[s]))
                for s in range(2)]
    data = zlib.decompress(stream, -15)
    body = torch.cat(outs)[: len(data)].to(torch.uint8).numpy().tobytes()
    assert body == data


@pytest.mark.parametrize("name", list(CASES))
def test_decode_split_emulated_equals_zlib(name):
    make, n = CASES[name]
    stream = make()
    got = ss.decode_split_emulated(stream, n, seg_bytes=SEG, device="cpu")
    assert got == zlib.decompress(stream, -15)


def test_decode_split_stream_over_a_mesh():
    """Each shard on its sp device of a (2, 4) mesh of repeated CPU
    devices, the tails moved by ring_tail_exchange: the emulated bytes."""
    data = _textish(150_000, seed=3)
    stream = deflate(data)
    mesh = make_mesh(dp=2, sp=4, devices=["cpu"] * 8)
    got = ss.decode_split_stream(stream, mesh=mesh, seg_bytes=SEG)
    assert got == data
    assert got == ss.decode_split_emulated(stream, 4, seg_bytes=SEG,
                                           device="cpu")


def test_seg_bytes_below_the_window_raises():
    with pytest.raises(ValueError, match="32 KiB"):
        ss.plan_split_stream(deflate(_textish(10_000)), 2, seg_bytes=SEG // 2)


def test_card_branch_launches_one_walk_per_nonempty_list(monkeypatch):
    """The card's branch of the walk, taken on CPU tensors with each
    launch recorded and emulated by the plain walk: one dbg_walk a shard
    and round whose list is not empty, given exactly the shard's records
    (no padding), nothing for an empty list (the trailing shards of six
    over 100 KB, a patch round of a clean shard), and the zlib bytes."""
    stream, n = CASES["more_shards_than_output_6"][0](), 6
    plan = ss.plan_split_stream(stream, n, seg_bytes=SEG)
    made = []

    def launch(entry, out, out_len, window, mdst, mmeta, n_m, rdst, rmeta,
               n_r, lit, n_lit):
        assert entry == "dbg_walk" and out_len == out.numel()
        made.append((n_m, n_r))
        tpb.walk_plain(out, mdst, mmeta, rdst, rmeta, lit)

    monkeypatch.setattr(tpb, "_plain_here", lambda t: False)
    monkeypatch.setattr(_kernels, "launch", launch)
    before = tpb.walk.launches
    got = ss.decode_split_emulated(stream, n, seg_bytes=SEG, device="cpu")
    monkeypatch.undo()
    assert got == zlib.decompress(stream, -15)
    want = [(len(p["mdst"]), len(p["rdst"])) for p in plan.phase1
            if len(p["mdst"]) or len(p["rdst"])]
    want += [(len(p["mdst"]), 0) for p in plan.patch
             if len(p["mdst"])] * plan.rounds
    assert made == want and tpb.walk.launches - before == len(want)
    assert len(want) < n * (1 + plan.rounds)  # empty lists launched nothing


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on card ``card``: enough for the
    launcher, which reads only its device, layout and address."""

    card = torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return type(self).card


def _on_card(i: int) -> torch.Tensor:
    cls = type(f"_OnCard{i}", (_OnCard,), {"card": torch.device("cuda", i)})
    return torch.Tensor._make_subclass(cls, torch.zeros(4, dtype=torch.int32))


def test_launch_runs_on_the_card_of_its_tensors(monkeypatch):
    """A shard of a mesh over several cards launches its walk with its own
    card current and on that card's current stream, whichever card the
    caller has current; tensors on two cards are refused.  The card, its
    streams and the C entry are stand-ins that record what they are
    handed."""
    current = [torch.device("cuda", 0)]
    made = []

    class Guard:
        def __init__(self, card):
            self.card = torch.device(card)

        def __enter__(self):
            self.prev, current[0] = current[0], self.card

        def __exit__(self, *exc):
            current[0] = self.prev

    def stream_of(card=None):
        card = torch.device(card) if card is not None else current[0]
        return type("Stream", (), {"cuda_stream": 1000 + card.index})()

    def entry(*args):
        made.append((args[-1], current[0]))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", stream_of)
    monkeypatch.setattr(_kernels, "_FNS", {"dbg_walk": entry})
    for i in (1, 2, 0, 3):
        out, m, r, lit = (_on_card(i) for _ in range(4))
        _kernels.launch("dbg_walk", out, 4, tpb.WINDOW, m, m, 0, r, r, 0,
                        lit, 4)
        assert made[-1] == (1000 + i, torch.device("cuda", i))
        assert current[0] == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="one CUDA device"):
        _kernels.launch("dbg_walk", _on_card(0), 4, tpb.WINDOW, _on_card(1),
                        _on_card(1), 0, _on_card(1), _on_card(1), 0,
                        _on_card(1), 4)
    assert len(made) == 4
