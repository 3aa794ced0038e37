#!/usr/bin/env python3
"""The corpus PNG decode, first call, pixels back on the host and pixels
left on the card (the port of tools/profile_corpus.py).

    python3 -m debigulator_tpu_torch.tools.profile_corpus [PNG ...] [--trace]

Decodes the 16 PNGs of ``tools/inputs.make_corpus()``, or the PNGs given,
with ``models/pipeline.decode_png_corpus_device``: the first call (its
seconds), every image checked against its source pixels (a given file
against the host decode, ``png_codec.decode_png``), then two calls with
numpy output and two with ``as_numpy=False`` at verbosity 2 (a line a
span on stderr, then the call's summary by layer), each ending in a
synchronise: ms and MB/s of RGBA.  With
``--trace``, a ``torch.profiler`` trace of one ``as_numpy=False`` call,
written to a new temporary directory: its top 30 ops (events over 100 us
summed by name) and every CUDA kernel.  Runs on the card; ``--device
cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.models.pipeline import decode_png_corpus_device
from debigulator_tpu_torch.models.png_codec import decode_png
from debigulator_tpu_torch.native.scanner import inflate_native
from debigulator_tpu_torch.tools.inputs import make_corpus
from debigulator_tpu_torch.tools.profile_merged import sync
from debigulator_tpu_torch.utils.config import get_config
from debigulator_tpu_torch.utils.profiling import (
    device_trace,
    trace_kernel_summary,
    trace_op_summary,
)

#: Timed calls of each kind.
REPS = 2


def profile(corpus: list[tuple[bytes, np.ndarray]], device="cuda",
            traced: bool = False) -> dict:
    """``corpus``: (PNG, expected RGBA) pairs.  The first call's seconds,
    the numpy-output and device-resident calls' ms, and with ``traced`` a
    call's top ops ([ms, name]) and kernels ([ms, launches, name])."""
    dev = resolve_device(device)
    blobs = [png for png, _ in corpus]
    t0 = time.perf_counter()
    imgs = decode_png_corpus_device(blobs, device=dev)
    first_s = time.perf_counter() - t0
    for k, ((_, want), got) in enumerate(zip(corpus, imgs, strict=True)):
        if not np.array_equal(got, want):
            raise AssertionError(f"image {k} differs from its source pixels")
    rgba_bytes = sum(want.nbytes for _, want in corpus)
    out = {"images": len(blobs), "png_bytes": sum(map(len, blobs)),
           "rgba_bytes": rgba_bytes, "first_s": first_s, "exact": True,
           "numpy_ms": [], "device_resident_ms": []}
    for _ in range(REPS):
        t0 = time.perf_counter()
        decode_png_corpus_device(blobs, device=dev)
        out["numpy_ms"].append((time.perf_counter() - t0) * 1e3)
    cfg = get_config()
    verbosity, cfg.verbosity = cfg.verbosity, 2
    try:
        for _ in range(REPS):
            t0 = time.perf_counter()
            decode_png_corpus_device(blobs, as_numpy=False, device=dev)
            sync(dev)
            out["device_resident_ms"].append((time.perf_counter() - t0) * 1e3)
    finally:
        cfg.verbosity = verbosity
    for key in ("numpy", "device_resident"):
        out[f"{key}_mbps"] = [rgba_bytes / ms / 1e3 for ms in out[f"{key}_ms"]]
    if traced:
        logdir = tempfile.mkdtemp(prefix="dbg_trace_corpus_")
        with device_trace(logdir, device=dev):
            decode_png_corpus_device(blobs, as_numpy=False, device=dev)
        out["logdir"] = logdir
        out["top_ops"] = [[t, name]
                          for t, name in trace_op_summary(logdir, top=30)]
        out["kernels"] = [list(row)
                          for row in trace_kernel_summary(logdir, top=None)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("png", nargs="*",
                    help="PNG files (default: the synthetic corpus)")
    ap.add_argument("--trace", action="store_true",
                    help="trace one device-resident call")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    corpus = []
    for path in args.png:
        with open(path, "rb") as f:
            png = f.read()
        corpus.append((png, decode_png(png, inflate_fn=inflate_native)))
    if not args.png:
        corpus = [(png, rgba) for _, png, rgba, _, _ in make_corpus()]
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    r = profile(corpus, dev, args.trace)
    print(f"{r['images']} images, {r['png_bytes']} PNG bytes, "
          f"{r['rgba_bytes']} RGBA bytes; first call {r['first_s']:.2f} s; "
          f"every image exact", flush=True)
    for ms, mbps in zip(r["numpy_ms"], r["numpy_mbps"]):
        print(f"full (numpy out): {ms:.1f} ms -> {mbps:.1f} MB/s", flush=True)
    for ms, mbps in zip(r["device_resident_ms"], r["device_resident_mbps"]):
        print(f"device-resident: {ms:.1f} ms -> {mbps:.1f} MB/s", flush=True)
    if args.trace:
        print(f"trace in {r['logdir']}; top ops:")
        for t, name in r["top_ops"]:
            print(f"  {t:9.2f} ms  {name}")
        print("device kernels:")
        for t, n, name in r["kernels"]:
            print(f"  {t:9.4f} ms  {n:3d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
