#!/usr/bin/env python3
"""The banded unfilter kernel (csrc/unfilter.cu) timed on the card.

    python3 -m debigulator_tpu_torch.tools.unfilter_bands

Random filtered scanlines from numpy seed 0 (random filter type per row)
through ``ops.unfilter.unfilter`` at shapes that separate the kernel's two
costs: one band of 32 rows (the per-step latency: w + 31 dependent steps)
at bpp 1, 4 and 8; 64 and 256 rows of the same width (the hand-off from
band to band); and the shapes the PNG paths give it (six 1024x1024 RGBA
images, 4096x4096 RGBA, 20,000 x 1 and 20,000 x 256 RGBA).  Each output is
checked against the plain version where that takes under a few seconds.
Prints one line per shape: ms per call from CUDA events over REPS calls
after the checked one, and ns per step of the last band.  Runs on the card
only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.ops import unfilter as uf

#: (h, w, bpp, batch) of each timed call.
SHAPES = [(32, 4096, 1, 1), (32, 4096, 4, 1), (32, 4096, 8, 1),
          (64, 4096, 4, 1), (256, 4096, 4, 1), (1024, 1024, 4, 6),
          (4096, 4096, 4, 1), (20_000, 1, 4, 1), (20_000, 256, 4, 1)]
#: Timed calls per shape.
REPS = 5
#: Largest h * w checked against the plain version (one tensor op sweep
#: per anti-diagonal).
CHECK_PIXELS = 300_000


def filtered_input(h: int, w: int, bpp: int, batch: int, seed: int = 0):
    """(batch, h * (1 + w * bpp)) uint8: random bytes, a random filter type
    (0-4) as each row's first byte."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (batch, h, 1 + w * bpp), dtype=np.uint8)
    raw[:, :, 0] = rng.integers(0, 5, (batch, h))
    return torch.from_numpy(raw.reshape(batch, -1))


def time_shape(h: int, w: int, bpp: int, batch: int, dev) -> dict:
    filt = filtered_input(h, w, bpp, batch).to(dev)
    got = uf.unfilter(filt, h, w, bpp)
    torch.cuda.synchronize()
    checked = h * w <= CHECK_PIXELS
    if checked and not torch.equal(got, uf.unfilter_plain(filt, h, w, bpp)):
        raise AssertionError(f"unfilter disagrees with its plain version at "
                             f"{h}x{w}x{bpp}")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        uf.unfilter(filt, h, w, bpp)
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / REPS
    return {"h": h, "w": w, "bpp": bpp, "batch": batch, "ms": ms,
            "bands": -(-h // uf.BAND_ROWS), "checked": checked,
            "ns_per_step_one_band": ms * 1e6 / (w + uf.BAND_ROWS - 1)}


def main() -> int:
    dev = resolve_device("cuda")
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    for shape in SHAPES:
        r = time_shape(*shape, dev)
        print(f"{r['batch']} x {r['h']:>5} x {r['w']:>4} bpp {r['bpp']}: "
              f"{r['ms']:9.4f} ms, {r['bands']:>4} bands"
              + (f", {r['ns_per_step_one_band']:.1f} ns a step"
                 if r["bands"] == 1 else "")
              + (", checked" if r["checked"] else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
