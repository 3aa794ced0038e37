#!/usr/bin/env python3
"""A short first run of the unfilter and greedy-walk kernels on the card.

    python3 -m debigulator_tpu_torch.tools.first_call

Compiles both sources with ``-Xptxas -v`` (registers, shared memory and
spills of each kernel), builds and loads the libraries, then holds each
kernel against its plain PyTorch version on random data made from numpy
seed 0 and prints one line per shape with the kernel's time by CUDA events
and the plain version's time.  Unfilter shapes: small ones with an
out-of-range filter byte, then the corpus shapes of chip_smoke.py.  Greedy
walk inputs of 4,195,328 positions: "img" (runs of seven equal bytes with
rare flips, a match about every seven positions), "zeros" (matches of 258
throughout) and "rand" (no match at all).  It is the cheap check to make
before a full run of chip_smoke.py when a kernel's source changes.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from debigulator_tpu_torch._build import BUILD_DIR
from debigulator_tpu_torch.ops import _kernels
from debigulator_tpu_torch.ops import deflate_encode_device as enc
from debigulator_tpu_torch.ops import unfilter as uf

UNFILTER_SHAPES = [(1, 16, 16, 4), (3, 9, 1, 3), (1, 1, 7, 4), (2, 33, 17, 1),
                   (1, 713, 1040, 3), (5, 713, 1040, 3), (1, 1024, 1024, 4),
                   (6, 1024, 1024, 4)]
WALK_INPUTS = [(100, "rand"), (5000, "zeros"), (4_195_328, "img"),
               (4_195_328, "zeros"), (4_195_328, "rand")]
LADDER = [1, 2, 3, 4, 8, 4097]


def event_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("first_call: no CUDA card", file=sys.stderr)
        return 1
    print(sys.version, torch.__version__, torch.version.cuda)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("unfilter", "greedy_walk"):
        r = subprocess.run(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
             str(_kernels.CSRC / _kernels.SOURCES[name]),
             "-o", str(BUILD_DIR / f"ptxas_{name}.so")],
            capture_output=True, text=True, timeout=600)
        print(name, r.returncode, r.stdout[-1500:], r.stderr[-3000:])
    print("build s", _kernels.build())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for nb, h, w, bpp in UNFILTER_SHAPES:
        raw = rng.integers(0, 256, (nb, h, 1 + w * bpp), dtype=np.uint8)
        raw[:, :, 0] = rng.integers(0, 6, (nb, h))
        t = torch.from_numpy(raw.reshape(nb, -1)).to(dev)
        got = uf.unfilter(t, h, w, bpp)
        torch.cuda.synchronize()
        t0 = time.time()
        want = uf.unfilter_plain(t, h, w, bpp)
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        ok = torch.equal(got, want)
        print("unfilter", nb, h, w, bpp, "equal", ok, "kernel ms",
              event_ms(lambda: uf.unfilter(t, h, w, bpp)), "plain s", plain_s,
              flush=True)
        if not ok:
            return 1
    for n, kind in WALK_INPUTS:
        if kind == "rand":
            data = rng.integers(0, 256, n, dtype=np.uint8)
        elif kind == "zeros":
            data = np.zeros(n, np.uint8)
        else:
            x = (np.arange(n) // 7 % 251).astype(np.uint8)
            data = x ^ (rng.integers(0, 50, n) == 0).astype(np.uint8)
        d = torch.from_numpy(data).to(dev)
        dists = [x for x in LADDER if x < n]
        bl, bd = enc.best_matches(d, dists)
        pk, mk = enc.greedy_walk(bl, bd)
        torch.cuda.synchronize()
        pp, mp = enc.greedy_walk_plain(bl, bd)
        ok = torch.equal(pk, pp) and torch.equal(mk, mp)
        print("greedy", n, kind, "records", pk.numel(), "equal", ok,
              "kernel ms", event_ms(lambda: enc.greedy_walk(bl, bd)),
              "plain ms", event_ms(lambda: enc.greedy_walk_plain(bl, bd), 1),
              "lengths ms", event_ms(lambda: enc.best_matches(d, dists)),
              flush=True)
        if not ok:
            return 1
    print("launches", uf.unfilter.launches, enc.greedy_walk.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
