"""Code sets the first-level decode table of the port's Phase A must get
right beyond a plan's, as Phase A table rows (numpy only): held against
the canonical probe on the CPU by tests/test_torch_phase_a_lut.py and
against the table kernel on the card by chip_smoke.py."""

import numpy as np

#: Code lengths of the fixed-Huffman litlen code (RFC 1951, 3.2.6).
FIXED_LL = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)


def tables_of_lengths(ll_lengths, d_lengths) -> np.ndarray:
    """One Phase A table row (TAB_W int32) from litlen and distance code
    lengths: count / first / base rows as the plan builds them, but with no
    check that the code fits, and distinct aug words (so an equal aug is an
    equal offset)."""
    row = np.zeros(416, np.int64)
    for r0, col0, width, lens in ((0, 96, 288, ll_lengths),
                                  (48, 384, 32, d_lengths)):
        count = np.bincount(np.asarray(lens, np.int64), minlength=16)[:16]
        count[0] = 0
        code = 0
        for bits in range(1, 16):
            code = (code + count[bits - 1]) << 1
            row[r0 + 16 + bits] = code
        row[r0 : r0 + 16] = count
        row[r0 + 33 : r0 + 48] = np.cumsum(count)[:-1]
        row[col0 : col0 + width] = np.arange(width) * 1777 + 3
    return row.astype(np.int32)


def synthetic_lut_tables() -> dict:
    """Code sets the first-level decode table must get right beyond a
    plan's: name -> (1, 416) int32 table rows."""
    rng = np.random.default_rng(3)
    z_ll, z_d = np.zeros(288, np.int64), np.zeros(32, np.int64)
    incomplete = (z_ll.copy(), z_d.copy())
    incomplete[0][[0, 1, 2, 3]] = [2, 4, 4, 4]
    incomplete[0][[65, 66, 67, 256, 257]] = 12
    incomplete[0][[70, 71]] = 14
    incomplete[1][[0, 4, 5, 6]] = [1, 11, 11, 11]
    # Over-subscribed past the table's bits: one code at each length up to
    # 11 (or 14), then more codes than the last length leaves room for.
    over = (z_ll.copy(), z_d.copy())
    over[0][:15] = list(range(1, 12)) + [12] * 4
    over[1][:17] = list(range(1, 15)) + [14] * 3
    single = (z_ll.copy(), z_d.copy())
    single[0][65] = 1
    single[1][3] = 1
    cases = {
        "incomplete": tables_of_lengths(*incomplete),
        "over_subscribed": tables_of_lengths(*over),
        "single_1bit": tables_of_lengths(*single),
        "all_15bit": tables_of_lengths(np.full(288, 15), np.full(32, 15)),
        "empty_distance": tables_of_lengths(FIXED_LL, z_d),
    }
    # count / first / base rows that follow no canonical code, so that the
    # probe's comparisons need not fail in order of length.
    rnd = tables_of_lengths(FIXED_LL, np.full(30, 5))
    for r0 in (0, 48):
        rnd[r0 : r0 + 16] = rng.integers(0, 6, 16)
        rnd[r0 + 16 : r0 + 32] = rng.integers(0, 200, 16)
        rnd[r0 + 32 : r0 + 48] = rng.integers(0, 300, 16)
    cases["random_rows"] = rnd
    return {k: v[None, :] for k, v in cases.items()}
