"""The group chase of the PyTorch port (csrc/group_chase.cuh), which
resolves rows 10a, 10g and 10h (``resolve_groups_v11``, ``_v9``, ``_v10``),
on hand-made piece lists (tests/torch_group_cases.py): the port's plain
twins against the JAX kernels in interpret mode, one call a segment with
the window carried, bit-exact; the card's branch with its C entries run
by a Python model of the kernels; and row 10c (``resolve_walk_v14``)
against its JAX kernel on a dense list that a byte is written twice in
and a clean group with an overlapping match."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debigulator_tpu.ops.archive import lz77_generations as ref_lg
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops.archive import lz77_generations as lg
from torch_group_cases import CASES, SEG, emulate, make, port_call
from torch_stream_cases import by_segment

VERSIONS = ("v9", "v10", "v11")


def _ref_call(version, init, lims, t):
    """The JAX kernel of ``version``, one call a segment (by_segment)."""
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}

    def call(buf, i):
        a = [jnp.asarray(buf), jnp.asarray(lims[i]), j["gpos"], j["gmeta"]]
        if version == "v9":
            return ref_lg.resolve_groups_v9(*a, interpret=True)
        fn = (ref_lg.resolve_groups_v10 if version == "v10"
              else ref_lg.resolve_groups_v11)
        return fn(*a, j["lpos"], j["lmeta"], j["lit"], seg_bytes=SEG,
                  interpret=True)

    return by_segment(call, init, lims.shape[0], SEG)


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("name", list(CASES))
def test_plain_twin_matches_the_reference_kernel(name, version):
    """Pieces reading what an earlier piece of their group writes, dist <
    len, sources above the piece or written by a later group, one byte
    written by two groups with a group between them reading it, two pieces
    of a group writing one byte, sources outside the buffer, padding, two
    segments in one call, many writers of one row: bit-exact."""
    init, lims, t = make(name, version)
    want = _ref_call(version, init, lims, t)
    got = port_call(version, init, lims, t)
    assert got.dtype == torch.int32 and got.shape == init.shape
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, init)


def test_v11_reads_the_bytes_before_its_group():
    """Row 10a's fault before the group chase: piece 0 of a group writes
    body bytes 1000..1019 from 500, piece 1 copies 10 bytes from 1005 to
    1300.  The JAX kernel loads both pieces before it stores, so 1300..1309
    get the bytes that 1005..1014 held before the group; resolving the
    pieces in DEFLATE order gave piece 0's bytes."""
    init, lims, t = make("reproducer", "v11")
    got = port_call("v11", init, lims, t).view(-1).numpy()
    flat = init.reshape(-1)
    b = lg.BODY_START
    assert np.array_equal(got[b + 1300 : b + 1310], flat[b + 1005 : b + 1015])
    assert np.array_equal(got[b + 1000 : b + 1020], flat[b + 500 : b + 520])
    assert (got[b + 1300 : b + 1310] != flat[b + 505 : b + 515]).all()
    want = _ref_call("v11", init, lims, t).reshape(-1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("name", list(CASES))
def test_card_branch_model_matches_the_plain_twin(monkeypatch, name,
                                                  version):
    """The card's branch on CPU tensors, its C entries run by the model of
    the kernels (torch_group_cases.group_chase), on a buffer that holds any
    int32: the plain twin's bytes, one launch counted, the literal entry
    (v10, v11) then the chase entry, each given as many arguments as its C
    entry takes, the chase its scratch for every buffer byte."""
    init, lims, t = make(name, version, seed=3, odd=True)
    want = port_call(version, init, lims, t)
    made = []
    monkeypatch.setattr(lg, "_plain_here", lambda x: False)
    monkeypatch.setattr(_kernels, "launch", emulate(made))
    fn = {"v9": lg.resolve_groups_v9, "v10": lg.resolve_groups_v10,
          "v11": lg.resolve_groups_v11}[version]
    before = fn.launches
    got = port_call(version, init, lims, t)
    assert torch.equal(got, want)
    assert fn.launches == before + 1
    chase = "dbg_groups_v11_chase" if version == "v11" else "dbg_groups_v9_chase"
    lits = {"v9": [], "v10": ["dbg_groups_v10_lits"],
            "v11": ["dbg_groups_v11_lits"]}[version]
    assert [e for e, _ in made] == lits + [chase]
    for entry, args in made:
        assert len(args) == len(_kernels._ENTRIES[entry][1])
    args = made[-1][1]
    assert args[1] == init.size and args[3] == lims.shape[0]
    assert args[6] == t["gpos"].numel()


def test_the_chase_ends_within_the_groups(monkeypatch):
    """Every pointer names an event of an earlier group, so a chase takes
    at most one round per group; on sixteen groups over one row the model
    needs far fewer (the pointers it publishes jump)."""
    from torch_group_cases import group_chase, v9_rec

    init, lims, t = make("many_writers", "v9")
    out = torch.from_numpy(init.copy())
    n = out.numel()
    scratch = lg.group_chase_state(n, t["gpos"].numel(), "cpu")
    rounds = group_chase(v9_rec(torch.from_numpy(lims), lims.shape[0],
                                t["gpos"], t["gmeta"]),
                         out, n, t["gpos"].numel(), *scratch)
    assert 0 < rounds <= 20
    want = port_call("v9", init, lims, t)
    assert torch.equal(out, want)


def test_group_chase_refuses_more_slots_than_its_ids_hold(monkeypatch):
    """A writer that is not its byte's last is named by -(slot * 128 +
    offset) - 2 in 32 bits: the wrapper refuses longer lists before any
    launch."""
    monkeypatch.setattr(lg, "GROUP_CHASE_SLOTS", 8)
    monkeypatch.setattr(lg, "_plain_here", lambda x: False)
    monkeypatch.setattr(_kernels, "launch", lambda *a: pytest.fail("launched"))
    init, lims, t = make("reproducer", "v9")
    with pytest.raises(ValueError, match="at most 8 slots"):
        port_call("v9", init, lims, t)


def _v14_list():
    """A dense v14 match list over one 8 KiB segment of random bytes:
    group 0 marked clean (bit 31 on its first match) with a match of
    distance 5 and length 40 at body offset 600; group 1 writes body bytes
    1010..1019 twice, in order, from two sources no match writes; group 2,
    clean, and group 3 read the twice-written bytes."""
    rng = np.random.default_rng(0)
    b = lg.BODY_START
    seg = 8192
    init = rng.integers(0, 256, b + seg + 512).astype(np.int32)
    groups = [[(500, 30, 200, True), (600, 40, 5, False), (700, 20, 300, False)],
              [(1000, 20, 100, False), (1010, 20, 800, False),
               (1100, 30, 90, False)],
              [(1500, 30, 495, True), (1600, 25, 595, False)],
              [(2000, 20, 990, False)]]
    dst = np.zeros(16 * 128, np.int64)
    meta = np.zeros(16 * 128, np.int64)
    for g, grp in enumerate(groups):
        for j, (d, n, dist, clean) in enumerate(grp):
            dst[g * 8 + j] = d
            meta[g * 8 + j] = (1 << 31 if clean else 0) | n << 16 | dist
    as32 = [a.astype(np.uint32).astype(np.int32).reshape(-1, 128)
            for a in (dst, meta)]
    lims = np.array([0, 8 * len(groups), 0, 0, 0, 0, 0, 0], np.int32)
    return init.reshape(-1, 128), lims, *as32


def test_walk_v14_against_the_reference_on_rewritten_bytes():
    """Row 10c against ``_walk_kernel_v14`` (interpret mode) where its
    contract does not reach: a byte written twice (the slow path, in
    order: the later match wins in both) and, inside a group marked clean,
    a match with dist < len.  The JAX kernel's fast path loads such a
    group before it stores, so body bytes 605..639 get the bytes that
    600..634 held before the group; the port repeats the pattern (the
    overlap rule).  Those 35 bytes, and only they, differ: the fault is
    logged in ROADMAP.md section C for the next slice."""
    init, lims, mdst, mmeta = _v14_list()
    z = np.zeros((16, 128), np.int32)
    lit = np.zeros((ref_lg.V14_LIT_ROWS + 8, 128), np.int32)
    want = np.asarray(ref_lg.resolve_walk_v14(
        jnp.asarray(init), jnp.asarray(lims), jnp.asarray(mdst),
        jnp.asarray(mmeta), jnp.asarray(z), jnp.asarray(z), jnp.asarray(lit),
        16, interpret=True)).reshape(-1)
    got = lg.resolve_walk_v14(
        torch.from_numpy(init), torch.from_numpy(lims),
        *(torch.from_numpy(a) for a in (mdst, mmeta, z, z)),
        torch.from_numpy(lit[:8])).view(-1).numpy()
    b = lg.BODY_START
    differ = np.flatnonzero(got != want) - b
    assert differ.tolist() == list(range(605, 640))
    flat = init.reshape(-1)
    assert np.array_equal(want[b + 605 : b + 640], flat[b + 600 : b + 635])
    assert np.array_equal(got[b + 1010 : b + 1030], flat[b + 210 : b + 230])
    assert np.array_equal(got[b + 2000 : b + 2020], want[b + 2000 : b + 2020])
