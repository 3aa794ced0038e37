#!/usr/bin/env python3
"""A 4096 x 4096 RGBA PNG of nearly incompressible pixels through the
device decode, bit-exact against the NumPy oracle and the source pixels
(the port of tools/check_4k_unfilter.py).

    python3 -m debigulator_tpu_torch.tools.check_4k_unfilter [--side N]

The image is ``tools/inputs.k4_png()`` (numpy ``default_rng(5)``, filter
types cycling 0-4, zlib level 6, 1 MiB IDAT chunks), built on the host.
The JAX tool ran the reference's one-dispatch "fused" PNG path, which the
port does not have; this one runs the port's ``decode_png_device``: the
native scan, the plan (chunked when the literal rows pass one call's cap),
the inflate kernels and the unfilter kernel.  Prints the PNG and RGBA
sizes, the first call's seconds, then checks the image against the NumPy
oracle and the source pixels, and prints a warm call's seconds and MB/s.

``ops/unfilter.unfilter_image`` steps pixel by pixel in Python, so the
oracle here runs the other way: the decode, filtered again with the
scanlines' own filter types (``inputs.filter_scanlines``, one vectorised
pass), must give the known scanlines byte for byte; as each filter type
has one inverse, that holds exactly when ``unfilter_image`` of the
scanlines equals the decode.  The CPU tests hold ``unfilter_image``
itself against the decode on a small image.  Runs on the card; ``--device
cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.models.pipeline import decode_png_device
from debigulator_tpu_torch.tools.inputs import filter_scanlines, k4_png

SIDE = 4096


def oracle_check(raw: bytes, rgba: np.ndarray) -> None:
    """Raise unless the (h, w, 4) ``rgba``, filtered with the filter types
    of the scanlines ``raw``, gives ``raw``."""
    h, w, _ = rgba.shape
    ftypes = np.frombuffer(raw, np.uint8)[:: 1 + 4 * w]
    again = np.frombuffer(filter_scanlines(rgba, ftypes), np.uint8)
    diff = np.flatnonzero(again != np.frombuffer(raw, np.uint8))
    if len(diff):
        raise AssertionError(f"the decode differs from the oracle from row "
                             f"{diff[0] // (1 + 4 * w)} on")


def check(png: bytes, raw: bytes, pix: np.ndarray, device="cuda") -> dict:
    """``decode_png_device`` of ``png`` (the filtered scanlines ``raw`` of
    the (h, w, 4) pixels ``pix``): first call, oracle and source checks,
    warm call.  Raises on any mismatch."""
    dev = resolve_device(device)
    h, w, _ = pix.shape
    t0 = time.perf_counter()
    rgba = decode_png_device(png, device=dev)
    first_s = time.perf_counter() - t0
    if rgba.shape != (h, w, 4):
        raise AssertionError(f"decoded shape {rgba.shape} != {(h, w, 4)}")
    t0 = time.perf_counter()
    oracle_check(raw, rgba)
    oracle_s = time.perf_counter() - t0
    if not np.array_equal(rgba, pix):
        raise AssertionError("the decode differs from the source pixels")
    del rgba
    t0 = time.perf_counter()
    rgba = decode_png_device(png, device=dev)
    warm_s = time.perf_counter() - t0
    if not np.array_equal(rgba, pix):
        raise AssertionError("the warm call differs from the source pixels")
    return {"side": f"{w}x{h}", "png_bytes": len(png), "rgba_bytes": pix.nbytes,
            "first_s": first_s, "oracle_s": oracle_s,
            "warm_s": warm_s, "warm_mbps": pix.nbytes / warm_s / 1e6,
            "exact": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=SIDE,
                    help="image side (default 4096)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    png, raw, pix = k4_png(args.side, args.side)
    print(f"synthetic png: {len(png) / 1e6:.1f} MB compressed, "
          f"{pix.nbytes / 1e6:.0f} MB RGBA, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    r = check(png, raw, pix, dev)
    print(f"device decode: {r['first_s']:.2f} s (first call)", flush=True)
    print(f"oracle: {r['oracle_s']:.1f} s; "
          f"equal to the decode and to the source pixels", flush=True)
    print(f"{r['side']} decode OK, bit-exact; warm {r['warm_s']:.2f} s = "
          f"{r['warm_mbps']:.0f} MB/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
