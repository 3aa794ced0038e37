#!/usr/bin/env python3
"""The piece-loop microbenchmark on the card (the port of
tools/microbench_pb.py).

    python3 -m debigulator_tpu_torch.tools.microbench_pb

Times the v12 narrow-piece group walk (csrc/microbench_pb.cu) and variants
of the group loop that drop parts of its work, over synthetic pieces made
from numpy seed 0 as the reference tool makes them: full and unroll2/4/8
(the group walk itself, one function, which the card runs as the event
chase), and the probes on the staged one-warp loop: load_only, store_only,
scalar_only (words unpacked and summed, no memory traffic), scalar_smem,
noop, noop8, nodma (the stage never filled), at 16, 64 and 256 staged
piece rows, over N_PIECES pieces.  Prints one line per run, labelled with
the design it ran: ms per call and ns per piece, from CUDA events over
REPS calls after the wrapper's check and one call.  Runs on the card only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops import lz77 as lz
from debigulator_tpu_torch.ops.archive import lz77_generations as lzgen
from debigulator_tpu_torch.ops.phase_b import _expand

N_PIECES = 1 << 21
ROWS = 4096 + 8
GROUP = 8
STAGE_ROWS = 16
#: Timed calls of a run, after its checked one.
REPS = 3
#: Row of the buffer that load_only and scalar_only overwrite.
ACC_ROW = 8
#: variant -> (kernel code in csrc/microbench_pb.cu, groups per iteration).
VARIANTS = {"full": (0, 1), "unroll2": (0, 2), "unroll4": (0, 4),
            "unroll8": (0, 8), "load_only": (1, 1), "store_only": (2, 1),
            "scalar_only": (3, 1), "scalar_smem": (4, 1), "noop": (5, 1),
            "noop8": (5, 8), "nodma": (6, 1)}
#: The runs of main(): the reference tool's list, then the other variants.
RUNS = (("noop", 16), ("noop", 64), ("noop", 256), ("nodma", 16),
        ("full", 16), ("full", 64), ("full", 256), ("scalar_smem", 256),
        ("noop8", 16), ("unroll2", 16), ("unroll4", 16), ("unroll8", 16),
        ("load_only", 16), ("store_only", 16), ("scalar_only", 16))
#: Staged rows a CTA can hold: 6 bytes a piece in at most 227 KB.
MAX_STAGE_ROWS = 256
#: The variants that run the group walk itself: on the card the event
#: chase (dbg_microbench_chase), the others the staged loop.
CHASE = ("full", "unroll2", "unroll4", "unroll8")
#: Events (written words) one chase call takes: numbered in int32.
MAX_EVENTS = 2**30


def make_pieces(n_pieces: int = N_PIECES, rows: int = ROWS, seed: int = 0):
    """The reference tool's synthetic v12 pieces: piece i lands at 1024 +
    16 i (modulo the buffer less 10 KiB), copies 4-23 bytes (cut at its
    128-byte row) from 384-4095 bytes back.  Returns (w0, w1), int32
    (n_pieces / 128, 128) numpy arrays: w0 = dst_row << 16 | rp << 8 | (rp
    + len), w1 = q_row << 16 | r << 8 | (128 - r), q = dst - dist - rp.
    The first pieces read before the buffer (q < 0)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_pieces, dtype=np.int64)
    dst = 1024 + (i * 16) % (rows * 128 - 8192 - 2048)
    dist = rng.integers(384, 4096, n_pieces)
    ln = np.minimum(rng.integers(4, 24, n_pieces), 128 - (dst & 127))
    rp = dst & 127
    q = dst - dist - rp
    r = q & 127
    w0 = ((dst >> 7) << 16) | (rp << 8) | (rp + ln)
    w1 = ((q >> 7) << 16) | (r << 8) | (128 - r)
    return (w0.reshape(-1, 128).astype(np.int32),
            w1.reshape(-1, 128).astype(np.int32))


def clash_pieces(seed: int = 0, rows: int = 18, n_pieces: int = 4096):
    """A hand-made clashing list in make_pieces' packing: (w0, w1, init),
    int32 numpy arrays.  Rounds of pieces (4-23 words, cut at the row) tile
    rows 8 to rows - 3, so that each round writes every word there once;
    the pieces of all rounds are shuffled and the first n_pieces kept, so
    that every word there is written about 50 times and a group's pieces
    share words.  A fifth of the pieces read 1-15 words back (their own
    group's words among them), the rest up to 1100 (some before the
    buffer).  init holds random words, zeros in rows 0-1 and the last two,
    which the reference kernel reads for a source before the buffer (its
    row index clamped, or counted from the end)."""
    rng = np.random.default_rng(seed)
    dst, lens = [], []
    while len(dst) < 2 * n_pieces:
        for w in range(8 * 128, (rows - 2) * 128, 128):
            at = 0
            while at < 128:
                n = min(int(rng.integers(4, 24)), 128 - at)
                dst.append(w + at)
                lens.append(n)
                at += n
    order = rng.permutation(len(dst))[:n_pieces]
    dst, ln = np.array(dst)[order], np.array(lens)[order]
    near = rng.random(n_pieces) < 0.2
    dist = np.where(near, rng.integers(1, 16, n_pieces),
                    rng.integers(16, 1100, n_pieces))
    rp = dst & 127
    q = dst - dist - rp
    r = q & 127
    w0 = ((dst >> 7) << 16) | (rp << 8) | (rp + ln)
    w1 = ((q >> 7) << 16) | (r << 8) | (128 - r)
    init = rng.integers(0, 256, (rows, 128))
    init[:2] = init[-2:] = 0
    return (w0.reshape(-1, 128).astype(np.int32),
            w1.reshape(-1, 128).astype(np.int32), init.astype(np.int32))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return (((x + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def _walked(w0, stage_rows: int) -> int:
    """Pieces the loop walks: whole stages only, as the reference's."""
    per = stage_rows * 128
    return w0.numel() // per * per


def microbench_plain(variant: str, w0, w1, init, stage_rows: int = STAGE_ROWS):
    """What one run of ``variant`` leaves in the buffer, in tensor ops.
    Pieces run in groups of 8, each group's loads before its stores,
    groups in order; a source byte outside the buffer reads as 0.  nodma
    raises: it reads staging memory that was never filled."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if variant == "nodma":
        raise ValueError("nodma reads a stage that is never filled: its "
                         "output is undefined")
    out = init.reshape(-1).clone()
    n = _walked(w0, stage_rows)
    if n == 0 or variant in ("noop", "noop8", "scalar_smem"):
        return out.view_as(init)
    a = w0.reshape(-1)[:n].long()
    b = w1.reshape(-1)[:n].long()
    base = (a >> 16) * 128
    rp, hi = (a >> 8) & 127, (a & 255).clamp(max=128)
    q = (b >> 16) * 128 + ((b >> 8) & 127)  # source window's first byte
    acc = slice(ACC_ROW * 128, ACC_ROW * 128 + 128)
    if variant == "scalar_only":
        out[acc] = _wrap32((a[-GROUP:] + b[-GROUP:]).sum())
    elif variant == "load_only":
        # Row ACC_ROW holds the previous group's sum: a group whose windows
        # meet it depends on the one before, back to one that does not.
        win = q[:, None] + torch.arange(128, device=out.device)[None, :]
        inside = (win >= 0) & (win < out.numel())
        in_acc = (win >= acc.start) & (win < acc.stop)
        fixed = torch.where(inside & ~in_acc,
                            out[win.clamp(0, out.numel() - 1)].long(), 0)
        sums = fixed.view(-1, GROUP, 128).sum(1)
        meets = in_acc.view(-1, GROUP * 128).any(1)
        g = sums.shape[0] - 1
        while g >= 0 and bool(meets[g]):
            g -= 1
        row = (sums[g] if g >= 0 else out[acc].long())
        for k in range(g + 1, sums.shape[0]):
            grp = slice(k * GROUP, (k + 1) * GROUP)
            row = sums[k] + torch.where(
                in_acc[grp], row[(win[grp] - acc.start).clamp(0, 127)],
                0).sum(0)
        out[acc] = _wrap32(row)
    else:
        length = (hi - rp).clamp(min=0)
        if variant == "store_only":
            rec, o = _expand(length)
            pos = base[rec] + rp[rec] + o
            out[pos[(pos >= 0) & (pos < out.numel())]] = 0
        else:  # full and unrollN: the group walk itself
            lz.group_walk_plain(
                out, base + rp, length, q + rp,
                torch.arange(n, device=out.device) // GROUP)
    return out.view_as(init)


def _check(variant, w0, w1, init, stage_rows: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    for t in (w0, w1, init):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 2 \
                or t.shape[1] != 128 or t.device != init.device:
            raise ValueError("words and buffer are contiguous (rows, 128) "
                             "int32 on one device")
    if w0.shape != w1.shape:
        raise ValueError("w0 and w1 must have one shape")
    if not 1 <= stage_rows <= MAX_STAGE_ROWS:
        raise ValueError(f"stage_rows must lie in [1, {MAX_STAGE_ROWS}]")
    if init.shape[0] <= ACC_ROW:
        raise ValueError(f"the buffer needs more than {ACC_ROW} rows")


def piece_events(w0, n_out: int, stage_rows: int = STAGE_ROWS):
    """Words each walked piece writes inside the buffer: its row's [rp,
    min(hi, 128)) cut to [0, n_out), as the event chase numbers them."""
    a = w0.reshape(-1)[:_walked(w0, stage_rows)].long()
    base = (a >> 16) * 128
    lo = (base + ((a >> 8) & 127)).clamp(min=0)
    hi = (base + (a & 255).clamp(max=128)).clamp(max=n_out)
    return (hi - lo).clamp(min=0)


def chase_scratch_bytes(n_out: int, n_pieces: int, n_events: int) -> int:
    """The event chase's scratch: the pieces' event ends and order, four
    counts or starts a 128-word row, a segment start a word, and per event
    a segment entry and a 64-bit state."""
    return (8 * n_pieces + 16 * (-(-n_out // 128) + 1) + 4 * (n_out + 1)
            + 12 * n_events)


def _plan(variant, w0, w1, n_out: int, stage_rows: int):
    """The card branch's one read-back: the packing check and, for the
    event chase, its event count.  Returns (ends, n_events) for the chase,
    ends the inclusive prefix sums of piece_events (int32), else None."""
    a, b = w0.long(), w1.long()
    dist = (a >> 16) * 128 - ((b >> 16) * 128 + ((b >> 8) & 127))
    ok = (((b & 255) == 128 - ((b >> 8) & 127))
          & (dist >= 0) & (dist < 1 << 16)).all().view(1).long()
    ends = None
    if variant in CHASE:
        ends = torch.cumsum(piece_events(w0, n_out, stage_rows), 0)
        ok = torch.cat([ok, ends[-1:] if ends.numel() else ok.new_zeros(1)])
    ok, *count = ok.tolist()
    if not ok:
        raise ValueError("pieces outside the v12 packing the card stages")
    if ends is None:
        return None
    if count[0] >= MAX_EVENTS:
        raise ValueError(f"the event chase takes fewer than {MAX_EVENTS} "
                         "written words a call")
    return ends.int(), count[0]


def _launch(variant, w0, w1, out, stage_rows: int, plan=None) -> None:
    """The card's launch of ``variant``, given _plan's result: nothing is
    read back, so a call replays from a CUDA graph."""
    if variant in CHASE:
        ends, n_events = plan
        if n_events:
            n_out = out.numel()
            i32 = dict(dtype=torch.int32, device=out.device)
            _kernels.launch(
                "dbg_microbench_chase", out, n_out, w0, w1, ends,
                ends.numel(), n_events, torch.empty(ends.numel(), **i32),
                torch.empty(4 * (-(-n_out // 128) + 1), **i32),
                torch.empty(n_out + 1, **i32), torch.empty(n_events, **i32),
                torch.empty(n_events, dtype=torch.int64, device=out.device))
            microbench.launches += 1
        return
    n_stages = _walked(w0, stage_rows) // (stage_rows * 128)
    if n_stages:
        code, unroll = VARIANTS[variant]
        _kernels.launch("dbg_microbench_pb", out, out.numel(), w0, w1,
                        n_stages, stage_rows, code, unroll)
        microbench.launches += 1


def microbench(variant: str, w0, w1, init, stage_rows: int = STAGE_ROWS):
    """One run of the piece loop under ``variant`` over the pieces (w0,
    w1) ((rows, 128) int32, make_pieces' packing) on a copy of ``init``
    ((rows, 128) int32); returns the buffer.

    CUDA kernels (csrc/microbench_pb.cu).  full and unrollN: the event
    chase, a 64-bit state per written word (the pieces bucketed by row
    and sorted, each word's writers listed row by row, then pointer, chase
    and store passes, in one entry), its scratch sized from the event
    count.  The probes: one CTA stages ``stage_rows`` rows
    of pieces into shared memory per round as w0 and the 16-bit distance,
    one warp walks their groups.  The card takes w1's low byte as 128 - r
    and a distance below 65,536: checked here, in the one read-back that
    also brings the event count.
    """
    _check(variant, w0, w1, init, stage_rows)
    if lzgen._plain_here(init):
        return microbench_plain(variant, w0, w1, init, stage_rows)
    plan = _plan(variant, w0, w1, init.numel(), stage_rows)
    out = init.clone()
    _launch(variant, w0, w1, out, stage_rows, plan)
    return out


microbench.launches = 0


def run_variant(variant: str, w0, w1, init,
                stage_rows: int = STAGE_ROWS) -> float:
    """ms per call of ``variant`` on the card: the wrapper's check (and
    event count) and one call, then CUDA events around REPS calls on one
    buffer."""
    _check(variant, w0, w1, init, stage_rows)
    plan = _plan(variant, w0, w1, init.numel(), stage_rows)
    out = init.clone()
    _launch(variant, w0, w1, out, stage_rows, plan)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        _launch(variant, w0, w1, out, stage_rows, plan)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def main() -> int:
    dev = resolve_device("cuda")
    print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    w0, w1 = (torch.from_numpy(w).to(dev) for w in make_pieces())
    init = torch.zeros((ROWS, 128), dtype=torch.int32, device=dev)
    for variant, sr in RUNS:
        ms = run_variant(variant, w0, w1, init, sr)
        ns = ms * 1e6 / max(_walked(w0, sr), 1)
        design = "chase" if variant in CHASE else "loop"
        print(f"{variant:12s} sr={sr:3d} {design:5s}: {ms:9.3f} ms "
              f"{ns:8.2f} ns/piece", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
