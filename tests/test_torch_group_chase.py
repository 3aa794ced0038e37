"""The group chase of the PyTorch port (csrc/group_chase.cuh), which
resolves rows 10a, 10g and 10h (``resolve_groups_v11``, ``_v9``, ``_v10``)
with groups of 8, rows 8, 10e and 10f (``resolve_matches_v4``,
``resolve_matches``, ``_v2``) with groups of one and row 10c
(``resolve_walk_v14``) with its clean groups: on hand-made piece lists
(tests/torch_group_cases.py), the port's plain twins against the JAX
kernels in interpret mode, one call a segment with the window carried,
bit-exact; the card's branch with its C entries run by a Python model of
the kernels; and row 10c against its JAX kernel on dense lists that write
bytes twice, inside and outside groups marked clean."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debigulator_tpu.ops.archive import lz77_generations as ref_lg
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops import lz77 as lz
from debigulator_tpu_torch.ops.archive import lz77_generations as lg
from torch_group_cases import (CASES, MATCH_LISTS, SEG, emulate, make,
                               match_list, port_call, serial_matches)
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
    scratch = lz.group_chase_state(n, t["gpos"].numel(), "cpu")
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
    clean, and group 3 read the twice-written bytes; group 4, clean, has
    two members writing bytes 2510..2519 (the later one wins); group 5,
    clean, has a member that writes 3010..3029 and a later member of
    distance 0 over 3000..3039, which stores those bytes as they were
    before the group; group 6 reads both."""
    rng = np.random.default_rng(0)
    b = lg.BODY_START
    seg = 8192
    init = rng.integers(0, 256, b + seg + 512).astype(np.int32)
    groups = [[(500, 30, 200, True), (600, 40, 5, False), (700, 20, 300, False)],
              [(1000, 20, 100, False), (1010, 20, 800, False),
               (1100, 30, 90, False)],
              [(1500, 30, 495, True), (1600, 25, 595, False)],
              [(2000, 20, 990, False)],
              [(2500, 20, 700, True), (2510, 20, 1500, False)],
              [(3010, 20, 900, True), (3000, 40, 0, False)],
              [(3500, 40, 1000, False), (3600, 40, 1100, False)]]
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


def _ref_walk_v14(init, lims, mdst, mmeta):
    """The JAX kernel (interpret mode) on a match list with no runs."""
    z = np.zeros((16, 128), np.int32)
    lit = np.zeros((ref_lg.V14_LIT_ROWS + 8, 128), np.int32)
    return np.asarray(ref_lg.resolve_walk_v14(
        jnp.asarray(init), jnp.asarray(lims), jnp.asarray(mdst),
        jnp.asarray(mmeta), jnp.asarray(z), jnp.asarray(z), jnp.asarray(lit),
        16, interpret=True))


def _port_walk_v14(init, lims, mdst, mmeta):
    z = torch.zeros((16, 128), dtype=torch.int32)
    return lg.resolve_walk_v14(
        *(torch.from_numpy(a) for a in (init, lims, mdst, mmeta)), z, z,
        torch.zeros((8, 128), dtype=torch.int32))


def test_walk_v14_against_the_reference_on_rewritten_bytes():
    """Row 10c against ``_walk_kernel_v14`` (interpret mode) on bytes
    written twice and on clean groups that break the hint: bit-exact.  A
    byte written twice outside a clean group takes the later match (the
    slow path, in order); a clean group loads before it stores, so body
    bytes 605..639 (a member of distance 5 and length 40) get the bytes
    that 600..634 held before the group, where the parent tree repeated
    the pattern and differed on those 35 bytes (fault C3); in a clean
    group the later of two writers of a byte wins, and a member of
    distance 0 stores its bytes as they were before the group."""
    init, lims, mdst, mmeta = _v14_list()
    want = _ref_walk_v14(init, lims, mdst, mmeta).reshape(-1)
    got = _port_walk_v14(init, lims, mdst, mmeta).view(-1).numpy()
    assert np.array_equal(got, want)
    b = lg.BODY_START
    flat = init.reshape(-1)
    assert np.array_equal(got[b + 605 : b + 640], flat[b + 600 : b + 635])
    assert np.array_equal(got[b + 1010 : b + 1030], flat[b + 210 : b + 230])
    assert np.array_equal(got[b + 2510 : b + 2530], got[b + 1010 : b + 1030])
    assert np.array_equal(got[b + 3000 : b + 3040], flat[b + 3000 : b + 3040])
    assert not np.array_equal(got[b + 3010 : b + 3030],
                              flat[b + 2110 : b + 2130])


def test_walk_v14_clean_group_across_segments():
    """A clean group of 8 that two segments of ``lims`` share: the JAX
    kernel, one call a segment, runs each part as a group of its own (the
    part in the second segment reads what the first part wrote), and so
    does the port's one call over both segments."""
    rng = np.random.default_rng(1)
    seg = 4096
    b = lg.BODY_START
    init = rng.integers(0, 256, b + 2 * seg + 512).astype(np.int32)
    # Slots 16..23 are one clean group; segment 0 holds slots 0..19.
    recs = {16: (3000, 20, 2000), 17: (3100, 30, 2500), 18: (3200, 10, 100),
            19: (3300, 40, 1200), 20: (seg + 100, 30, seg + 100 - 3105),
            21: (seg + 300, 30, seg + 300 - 3000), 22: (seg + 500, 20, 7),
            23: (seg + 600, 40, 0)}
    dst = np.zeros(16 * 128, np.int64)
    meta = np.zeros(16 * 128, np.int64)
    for q, (d, n, dist) in recs.items():
        dst[q], meta[q] = d, n << 16 | dist
    meta[16] |= 1 << 31
    for q in range(16):  # segment 0's own matches before the group
        dst[q], meta[q] = 200 * q + 50, 20 << 16 | (30 + q)
    mdst, mmeta = (a.astype(np.uint32).astype(np.int32).reshape(-1, 128)
                   for a in (dst, meta))
    lims = np.array([[0, 20, 0, 0, 0, 0, 0, 0], [20, 24, 0, 0, seg, 0, 0, 0]],
                    np.int32)
    init2 = init.reshape(-1, 128)
    want = by_segment(lambda buf, i: _ref_walk_v14(buf, lims[i], mdst, mmeta),
                      init2, 2, seg)
    got = _port_walk_v14(init2, lims, mdst, mmeta)
    assert np.array_equal(got.numpy(), want)
    flat = got.view(-1).numpy()
    assert np.array_equal(flat[b + seg + 100 : b + seg + 130],
                          flat[b + 3105 : b + 3135])


def _match_call(version, buf, pos, meta, n):
    """The port's match-list resolver of ``version`` (v4: up to n)."""
    args = [torch.from_numpy(a.copy()) for a in (buf, pos, meta)]
    if version == "v4":
        return lz.resolve_matches_v4(*args, n)
    fn = lg.resolve_matches if version == "v1" else lg.resolve_matches_v2
    return fn(*args)


#: Each version's buffer: (body origin, prologue bytes).
MATCH_LAYOUT = {"v4": (lg.BODY_START, lg.BODY_START),
                "v2": (lg.BODY_START, lg.BODY_START),
                "v1": (lg.WINDOW, lg.WINDOW)}


@pytest.mark.parametrize("version", ["v4", "v1", "v2"])
@pytest.mark.parametrize("name", list(MATCH_LISTS))
def test_match_card_branch_model_matches_the_plain_twin(monkeypatch, name,
                                                        version):
    """Rows 8, 10e and 10f on the card's branch, on CPU tensors, with
    ``dbg_lz77_match`` run by the model of the chase (groups of one,
    torch_group_cases.match_rec): the plain twin's bytes, which are the
    serial walk's, one launch counted, the entry given its scratch for
    every buffer byte and every match (v1 and v2 over every entry)."""
    origin, prologue = MATCH_LAYOUT[version]
    buf, pos, meta, n = match_list(name, origin, prologue)
    if version != "v4":
        n = pos.size
    want = _match_call(version, buf, pos, meta, n)
    assert np.array_equal(want.numpy(), serial_matches(buf, pos, meta, n))
    made = []
    for mod in (lz, lg):
        monkeypatch.setattr(mod, "_plain_here", lambda x: False)
    monkeypatch.setattr(_kernels, "launch", emulate(made))
    fn = {"v4": lz.resolve_matches_v4, "v1": lg.resolve_matches,
          "v2": lg.resolve_matches_v2}[version]
    before = fn.launches
    got = _match_call(version, buf, pos, meta, n)
    assert torch.equal(got, want)
    assert fn.launches == before + 1
    assert [e for e, _ in made] == ["dbg_lz77_match"]
    args = made[0][1]
    assert len(args) == len(_kernels._ENTRIES["dbg_lz77_match"][1])
    assert args[1] == buf.size and args[4] == n
