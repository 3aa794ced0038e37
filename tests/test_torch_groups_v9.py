"""The archived group resolvers of the PyTorch port (v9
``resolve_groups_v9``, v10 ``resolve_groups_v10``), the v10-era packing
(``host_fed.build_group_arrays_v10``) and their decodes (``inflate_v9``,
``inflate_v10_wide``) against the JAX package's Pallas kernels (interpret
mode) and zlib, on device="cpu" (the kernels' plain versions).  Bit-exact
everywhere."""

import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debigulator_tpu.ops import lz77_pallas as ref_lz
from debigulator_tpu.ops.archive import lz77_generations as ref_lg
from debigulator_tpu_torch.native import scanner as tns
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops import lz77 as lz
from debigulator_tpu_torch.ops.archive import host_fed as hf
from debigulator_tpu_torch.ops.archive import inflate_generations as ig
from debigulator_tpu_torch.ops.archive import lz77_generations as lg
from debigulator_tpu_torch.parallel import merged as tm
from torch_group_cases import emulate
from torch_stream_cases import STREAMS, deflate, words

SEG = 4096


def _text(seed, n=20000):
    rng = random.Random(seed)
    return "".join(rng.choice("abcdefgh \n") for _ in range(n)).encode()


def _stored_mix():
    rng = random.Random(9)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    parts = []
    for i in range(5):
        chunk = (b"repeat me " * 200) if i % 2 else bytes(rng.randbytes(2000))
        parts += [co.compress(chunk), co.flush(zlib.Z_FULL_FLUSH)]
    return b"".join(parts) + co.flush()


CASES = {
    "level1": lambda: [deflate(_text(1) + words(3000, seed=1), 1)],
    "level6": lambda: [deflate(_text(6) + words(3000, seed=6), 6)],
    "level9": lambda: [deflate(words(4000, seed=9) + _text(9), 9)],
    "stored_mix": lambda: [_stored_mix()],
    "batch3": lambda: [STREAMS["rle"](), deflate(words(5000, seed=3), 9),
                       STREAMS["far"]()],
}


def _np(x):
    return np.asarray(x)


def _plan(streams):
    mp = tm.build_merged_plan(streams, records=True)
    return mp, np.frombuffer(b"".join(zlib.decompress(s, -15)
                                      for s in streams), np.uint8)


@pytest.mark.parametrize("name", list(CASES))
def test_pack_groups_pieces_fit_the_group_kernels(name):
    """The packer at HEAD still gives what the v9/v10 kernels assume:
    pieces of at most 128 bytes, no piece reading what its group writes,
    no two pieces of a group writing one byte, groups inside a segment."""
    mp, _ = _plan(CASES[name]())
    n_seg = -(-mp.plan.out_size // SEG)
    g_pos, g_meta, lo, hi = tns.pack_groups(mp.recs["m_pos"], mp.recs["m_meta"],
                                            SEG, n_seg)
    pos = g_pos.astype(np.int64).reshape(-1, 8)
    ln = (g_meta.astype(np.int64) >> 16).reshape(-1, 8)
    src = pos - (g_meta.astype(np.int64) & 0xFFFF).reshape(-1, 8)
    assert len(g_pos) % 8 == 0 and ln.max() <= 128 and ln.min() >= 0
    assert (ln > 0).any(axis=1).all()
    live = ln > 0
    for a in range(8):
        for b in range(8):
            both = live[:, a] & live[:, b]
            reads = both & (src[:, a] < pos[:, b] + ln[:, b]) & (
                src[:, a] + ln[:, a] > pos[:, b])
            assert not reads.any(), (a, b)
            if a != b:
                writes = both & (pos[:, a] < pos[:, b] + ln[:, b]) & (
                    pos[:, a] + ln[:, a] > pos[:, b])
                assert not writes.any(), (a, b)
    # Every live piece lies in the segment whose slot range holds it.
    k = np.repeat(np.arange(n_seg), hi - lo).reshape(-1, 8)
    assert np.array_equal((pos // SEG)[live], k[live])


def _runs_body(recs, stored_pos, stored_val, total):
    """The body with the literal runs and stored bytes placed (the v9
    kernel's input), numpy."""
    body = np.zeros(total, np.int32)
    for p, l0, j in zip(recs["r_pos"], recs["r_lit0"], recs["r_j0len"]):
        n = int(j) & 0xFF
        body[p : p + n] = recs["lit"][l0 : l0 + n]
    body[stored_pos] = stored_val
    return body


def _segment_buffer(tail_src, off, body_seg):
    """Pad row, the 32 KiB before ``off`` of ``tail_src``, the segment's
    body, 4 slack rows, as (rows, 128) int32."""
    w = lz.WINDOW
    init = np.zeros(lz.PAD + w + len(body_seg) + 512, np.int32)
    tail = tail_src[max(0, off - w) : off]
    init[lz.BODY_START - len(tail) : lz.BODY_START] = tail
    init[lz.BODY_START : lz.BODY_START + len(body_seg)] = body_seg
    return init.reshape(-1, 128)


def _ref_call(version, init, lim, t):
    args = [jnp.asarray(init), jnp.asarray(lim), jnp.asarray(t["gpos"].numpy()),
            jnp.asarray(t["gmeta"].numpy())]
    if version == "v9":
        return _np(ref_lg.resolve_groups_v9(*args, interpret=True))
    return _np(ref_lg.resolve_groups_v10(
        *args, jnp.asarray(t["lpos"].numpy()), jnp.asarray(t["lmeta"].numpy()),
        jnp.asarray(t["lit"].numpy()), seg_bytes=SEG, interpret=True))


def _port_call(version, init, lim, t):
    args = (torch.from_numpy(init), torch.from_numpy(np.ascontiguousarray(lim)),
            t["gpos"], t["gmeta"])
    if version == "v9":
        return lg.resolve_groups_v9(*args)
    return lg.resolve_groups_v10(*args, t["lpos"], t["lmeta"], t["lit"])


def _first_body(version, mp, data):
    total = -(-mp.plan.out_size // SEG) * SEG
    if version == "v10":
        body = np.zeros(total, np.int32)
        body[mp.plan.stored_pos] = mp.plan.stored_val
        return body
    return _runs_body(mp.recs, mp.plan.stored_pos, mp.plan.stored_val, total)


@pytest.mark.parametrize("seg", [0, 2])
@pytest.mark.parametrize("version", ["v9", "v10"])
def test_one_segment_matches_the_reference_kernel(version, seg):
    """One 4 KiB segment (its window the stream's bytes before it): seg 2
    has a non-zero offset and literal row base, and padding slots."""
    mp, data = _plan([deflate(_text(4, 6000) + words(3000, seed=5), 6)])
    n_seg = -(-mp.plan.out_size // SEG)
    t = hf.build_group_arrays_v10(mp.recs, n_seg, seg_bytes=SEG, device="cpu")
    lim = t["lims"].numpy()[seg]
    if seg:
        assert lim[2] and lim[5] and (lim[1] - lim[0]) % 8 == 0
    off = seg * SEG
    body = _first_body(version, mp, data)
    init = _segment_buffer(data, off, body[off : off + SEG])
    want = _ref_call(version, init, lim, t)
    got = _port_call(version, init, lim, t)
    assert np.array_equal(got.numpy(), want)
    n = min(SEG, len(data) - off)
    out = got.view(-1)[lz.BODY_START : lz.BODY_START + n].numpy()
    assert np.array_equal(out, data[off : off + n])
    if version == "v9":  # padding slots: len 0 at the segment's offset
        g = t["gmeta"].view(-1)[lim[0] : lim[1]]
        assert ((g == 0) & (t["gpos"].view(-1)[lim[0] : lim[1]] == off)).any()


@pytest.mark.parametrize("version", ["v9", "v10"])
def test_two_segments_in_one_call(version):
    """Segments 1 and 2 in one port call (lims rows, one buffer holding
    both bodies) against two reference calls, the second one's window the
    first one's tail."""
    mp, data = _plan([deflate(_text(7, 4000) + words(3000, seed=7), 9)])
    n_seg = -(-mp.plan.out_size // SEG)
    assert n_seg >= 3
    t = hf.build_group_arrays_v10(mp.recs, n_seg, seg_bytes=SEG, device="cpu")
    lims = t["lims"].numpy()
    body = _first_body(version, mp, data)
    init1 = _segment_buffer(data, SEG, body[SEG : 2 * SEG])
    out1 = _ref_call(version, init1, lims[1], t).reshape(-1)
    init2 = _segment_buffer(out1[lz.PAD :].astype(np.int32), lz.WINDOW + SEG,
                            body[2 * SEG : 3 * SEG])
    out2 = _ref_call(version, init2, lims[2], t).reshape(-1)
    both = _segment_buffer(data, SEG, body[SEG : 3 * SEG])
    got = _port_call(version, both, lims[1:3], t).view(-1).numpy()
    b = lz.BODY_START
    assert np.array_equal(got[b : b + SEG], out1[b : b + SEG])
    assert np.array_equal(got[b + SEG : b + 2 * SEG], out2[b : b + SEG])
    assert np.array_equal(got[b : b + 2 * SEG], data[SEG : 3 * SEG])


def _clashing_groups(seed, with_lits):
    """Hand-made groups that are not conflict-free: pieces read what an
    earlier piece of their group writes, overlap themselves (dist < len)
    and write over each other, with padding slots and groups of the
    neighbouring segments around the live slot range.  The group
    semantics (all loads, then the stores in slot order) decides."""
    rng = np.random.default_rng(seed)
    off = 3 * SEG
    n_grp = 40
    dst = off + rng.integers(0, SEG - 256, (n_grp, 8))
    ln = rng.integers(1, 129, (n_grp, 8))
    dist = rng.integers(0, 600, (n_grp, 8))
    for g in range(n_grp):  # later pieces read an earlier piece's bytes
        for k in range(1, 8, 2):
            dist[g, k] = max(0, dst[g, k] - dst[g, k - 1] - int(rng.integers(0, 40)))
        ln[g, 6] = 0  # a padding slot
    dist[:, 7] = rng.integers(1, 20, n_grp)  # dist < len
    meta = (ln << 16) | dist
    pos = dst.copy()
    pos[:, 6] = off
    gpos = np.concatenate([np.full(16, off - SEG), pos.reshape(-1),
                           np.full(8, off + SEG)])
    gmeta = np.concatenate([np.full(16, (50 << 16) | 7), meta.reshape(-1),
                            np.full(8, (50 << 16) | 7)])
    lim = np.array([16, 16 + 8 * n_grp, off, 0, 0, 0, 0, 0], np.int32)
    t = {"gpos": torch.from_numpy(tm._pad_rec_rows(gpos.astype(np.int32), 16)),
         "gmeta": torch.from_numpy(tm._pad_rec_rows(gmeta.astype(np.int32), 16))}
    init = rng.integers(0, 256, lz.BODY_START + SEG + 512).astype(np.int32)
    if with_lits:
        # Disjoint literal pieces of at most 64 bytes, one crossing a row,
        # the slice 5 rows into the literal array.
        starts = np.arange(40, SEG - 200, 150)[:24]
        lens = rng.integers(1, 65, len(starts))
        lens[0] = 64
        starts[0] = 128 * 4 + 100
        rel = 128 + np.cumsum(np.concatenate([[0], lens[:-1]]))
        lpos = np.concatenate([off + starts, np.full(8 - len(starts) % 8, off)])
        lmeta = np.concatenate([(lens << 20) | rel,
                                np.zeros(8 - len(starts) % 8, np.int64)])
        lim[3:6] = [0, len(lpos), 5]
        lit = rng.integers(0, 256, (5 + SEG // 128 + 8) * 128).astype(np.int32)
        t.update(lpos=torch.from_numpy(tm._pad_rec_rows(lpos.astype(np.int32), 16)),
                 lmeta=torch.from_numpy(tm._pad_rec_rows(lmeta.astype(np.int32), 16)),
                 lit=torch.from_numpy(lit.reshape(-1, 128)))
    return init.reshape(-1, 128), lim, t


@pytest.mark.parametrize("version", ["v9", "v10"])
def test_group_semantics_on_clashing_groups(version):
    init, lim, t = _clashing_groups(11, version == "v10")
    want = _ref_call(version, init, lim, t)
    got = _port_call(version, init, lim, t)
    assert np.array_equal(got.numpy(), want)
    # In slot order, one piece after another, the bytes differ: the
    # groups' loads really come first.
    dst, ln, dist, _ = lg._match_pieces(torch.from_numpy(lim).view(1, 8),
                                        t["gpos"], t["gmeta"])
    seq = torch.from_numpy(want.reshape(-1).copy())
    if version == "v10":
        seq = torch.from_numpy(init.reshape(-1).copy())
        d, n, s = lg._lit_pieces(torch.from_numpy(lim).view(1, 8), t["lpos"],
                                 t["lmeta"])
        for a, b, c in zip(d.tolist(), n.tolist(), s.tolist()):
            seq[a : a + b] = t["lit"].view(-1)[c : c + b]
    else:
        seq = torch.from_numpy(init.reshape(-1).copy())
    for a, b, c in zip(dst.tolist(), ln.tolist(), dist.tolist()):
        for i in range(b):
            seq[a + i] = seq[a + i - c]
    assert not np.array_equal(seq.numpy(), want.reshape(-1))


@pytest.mark.parametrize("case", ["level6", "batch3"])
def test_build_group_arrays_v10(case):
    """The v10-era packing beside the row-split one (build_piece_arrays):
    the same match slots and segment limits, the packer's words as they
    are, literal pieces split at segment boundaries only."""
    mp, data = _plan(CASES[case]())
    n_seg = -(-mp.plan.out_size // SEG)
    t = hf.build_group_arrays_v10(mp.recs, n_seg, seg_bytes=SEG, device="cpu")
    row = hf.build_piece_arrays(mp.recs, n_seg, seg_bytes=SEG, device="cpu")
    assert set(t) == set(row) and all(v.dtype == torch.int32 for v in t.values())
    lims, rlims = t["lims"].numpy(), row["lims"].numpy()
    assert np.array_equal(lims[:, [0, 1, 2, 5]], rlims[:, [0, 1, 2, 5]])
    assert np.array_equal(t["lit"].numpy(), row["lit"].numpy())
    g_pos, g_meta, _, _ = tns.pack_groups(mp.recs["m_pos"], mp.recs["m_meta"],
                                          SEG, n_seg)
    assert np.array_equal(t["gpos"].view(-1)[: len(g_pos)].numpy(), g_pos)
    assert np.array_equal(t["gmeta"].view(-1)[: len(g_meta)].numpy(), g_meta)
    lpos, lmeta = t["lpos"].view(-1).numpy(), t["lmeta"].view(-1).numpy()
    ln = lmeta >> 20
    total = int((mp.recs["r_j0len"].astype(np.int64) & 0xFF).sum())
    assert ln.sum() == total and ln.max() <= 64
    assert ((lpos % 128) + ln > 128).any()  # not split at rows
    for k in range(n_seg):
        s = slice(lims[k, 3], lims[k, 4])
        assert ((lpos[s] // SEG == k) | (ln[s] == 0)).all()
        pad = slice(lims[k, 4], lims[k + 1, 3] if k + 1 < n_seg else len(lpos))
        assert (lmeta[pad] == 0).all()
        if k + 1 < n_seg:
            assert (lpos[pad] == k * SEG).all()
    assert lims[:, 3].tolist() == sorted(lims[:, 3].tolist())
    assert (lims[:, 3] % 8 == 0).all()


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("driver", ["v9", "v10_wide"])
def test_decode_against_zlib(driver, name):
    streams = CASES[name]()
    mp, data = _plan(streams)
    n_seg = inf.n_segments(mp.plan.out_size)
    t = hf.build_group_arrays_v10(mp.recs, n_seg, device="cpu")
    sp = torch.from_numpy(mp.plan.stored_pos)
    sv = torch.from_numpy(mp.plan.stored_val)
    if driver == "v9":
        body = ig.inflate_v9(hf.literal_runs(mp.recs, device="cpu"), t, sp, sv,
                             n_seg)
    else:
        body = ig.inflate_v10_wide(t, sp, sv, n_seg)
    assert body.dtype == torch.int32 and body.numel() == n_seg * ig.SEG_BYTES
    out = body[: mp.plan.out_size].to(torch.uint8).numpy()
    for s, o, n in zip(streams, mp.out_offsets, mp.out_sizes):
        assert out[o : o + n].tobytes() == zlib.decompress(s, -15)


@pytest.mark.parametrize("case", ["clashing_v9", "clashing_v10", "packed_v10"])
def test_card_branch_emulated(monkeypatch, case):
    """The card's branch of the wrappers, taken on CPU tensors with the C
    entries emulated by a Python model of the kernels
    (torch_group_cases.emulate: the literal pass, then the group chase's
    mark, pointer, chase and store passes over the arguments the wrapper
    hands them: the last and first writer and the 64-bit state of every
    buffer byte, the rows' lists of pieces): the plain version's bytes,
    and each call that launches counts one."""
    version = case.rsplit("_", 1)[1]
    if case.startswith("clashing"):
        init, lim, t = _clashing_groups(4, version == "v10")
    else:
        mp, data = _plan(CASES["batch3"]())
        n_seg = -(-mp.plan.out_size // SEG)
        t = hf.build_group_arrays_v10(mp.recs, n_seg, seg_bytes=SEG,
                                      device="cpu")
        lim = t["lims"].numpy()
        init = _segment_buffer(data, 0, np.zeros(n_seg * SEG, np.int32))
    want = _port_call(version, init, lim, t)
    made = []
    monkeypatch.setattr(lg, "_plain_here", lambda x: False)
    monkeypatch.setattr(_kernels, "launch", emulate(made))
    fn = lg.resolve_groups_v9 if version == "v9" else lg.resolve_groups_v10
    before = fn.launches
    got = _port_call(version, init, lim, t)
    assert torch.equal(got, want)
    assert fn.launches == before + 1
    entries = [e for e, _ in made]
    assert entries[-1] == "dbg_groups_v9_chase"
    assert ("dbg_groups_v10_lits" in entries) == (version == "v10")
    last, first, state = made[-1][1][-5:-2]
    assert last.numel() == first.numel() == state.numel() == init.size
    if case == "packed_v10":
        assert got.view(-1)[lz.BODY_START : lz.BODY_START + len(data)].numpy() \
            .astype(np.uint8).tobytes() == data.tobytes()
        # The packer's lists: every written byte has one writer.
        assert (first == 0x7F7F7F7F).all() and (last >= 0).any()
    assert ref_lz.PAD == lz.PAD
