#!/usr/bin/env python3
"""The DEFLATE encoders phase by phase: the device encoder on a filtered
image and the host encoder (the encode default) on a crop of it (the port
of tools/profile_encoder.py).

    python3 -m debigulator_tpu_torch.tools.profile_encoder [PNG] [--host-crop N]

The image is the first RGBA image of ``tools/inputs.make_corpus()`` (1024
x 1024), or the PNG given, its rows filtered by ``inputs.filter_scanlines``
(stride 4 * width + 1).  Device encoder: ``deflate_fixed_device`` (one
warm-up call, then one timed: ms, MB/s of filtered bytes, bytes out,
checked with zlib), ``lz77_select_device`` (match lengths, greedy-walk
kernel, read-back), ``lz77_parse_device`` (the same plus the token
arrays), then the host's ``_tokens_to_fields`` with the fixed tables and
``pack_bits`` with the end-of-block code, whose bytes must be
``deflate_fixed_device``'s.  Host encoder, on the centred
``--host-crop`` square (default 256: the whole 1024 x 1024 image takes
minutes): ``lz77_parse``, with the time of its ``_match_lengths`` calls,
and ``deflate`` (checked with zlib).  Host clocks; each phase reads its
result back.  Runs on the card; ``--device cpu`` runs the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import sys
import time
import zlib

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.models.png_codec import decode_png
from debigulator_tpu_torch.native.scanner import inflate_native
from debigulator_tpu_torch.ops import deflate_encode as enc
from debigulator_tpu_torch.ops import deflate_encode_device as denc
from debigulator_tpu_torch.tools.inputs import filter_scanlines, make_corpus

#: Side of the centred square the host encoder takes.
HOST_CROP = 256


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def device_phases(rgba: np.ndarray, device="cuda") -> dict:
    """The device encoder on the filtered rows of (h, w, 4) ``rgba``."""
    dev = resolve_device(device)
    h, w, _ = rgba.shape
    filt = filter_scanlines(rgba)
    data = np.frombuffer(filt, np.uint8)
    stride = 4 * w + 1
    out = {"image": f"{w}x{h}", "filtered_bytes": len(data)}
    denc.deflate_fixed_device(filt, stride=stride, device=dev)
    t0 = time.perf_counter()
    blob = denc.deflate_fixed_device(filt, stride=stride, device=dev)
    out["deflate_fixed_device_ms"] = _ms(t0)
    if zlib.decompress(blob, -15) != filt:
        raise AssertionError("deflate_fixed_device does not decode to its input")
    out["deflate_bytes"] = len(blob)
    out["mbps"] = len(data) / out["deflate_fixed_device_ms"] / 1e3
    t0 = time.perf_counter()
    sel, _, _ = denc.lz77_select_device(data, stride=stride, device=dev)
    out["select_ms"] = _ms(t0)
    out["matches"] = len(sel)
    t0 = time.perf_counter()
    tokens = denc.lz77_parse_device(data, stride=stride, device=dev)
    out["parse_ms"] = _ms(t0)
    out["tokens"] = len(tokens[0])
    t0 = time.perf_counter()
    vals, bits = enc._tokens_to_fields(
        tokens, enc._FIXED_LITLEN_CODES, enc._FIXED_LITLEN_LENGTHS,
        enc._FIXED_DIST_CODES, enc._FIXED_DIST_LENGTHS)
    out["tokens_to_fields_ms"] = _ms(t0)
    # The end-of-block code, as deflate_fixed_device appends it.
    eob_bits = int(enc._FIXED_LITLEN_LENGTHS[256])
    eob_val = int(enc._reverse_bits(
        np.array([enc._FIXED_LITLEN_CODES[256]]), np.array([eob_bits]))[0])
    vals = np.concatenate([vals, [np.uint64(eob_val)]])
    bits = np.concatenate([bits, [eob_bits]])
    t0 = time.perf_counter()
    packed, _ = enc.pack_bits(vals, bits, prefix_bits=3, prefix_val=0b011)
    out["pack_bits_ms"] = _ms(t0)
    # deflate_fixed_device stores the data instead when packing is larger.
    n = len(data)
    if len(packed) < n + 5 * ((n + 65534) // 65535) and packed != blob:
        raise AssertionError("the phases do not give deflate_fixed_device's "
                             "bytes")
    return out


def host_phases(rgba: np.ndarray, side: int = HOST_CROP) -> dict:
    """The host encoder on the filtered rows of the centred ``side`` square
    of ``rgba`` (the whole image when it is smaller)."""
    h, w, _ = rgba.shape
    y0, x0 = max(0, (h - side) // 2), max(0, (w - side) // 2)
    crop = np.ascontiguousarray(rgba[y0 : y0 + side, x0 : x0 + side])
    filt = filter_scanlines(crop)
    out = {"crop": f"{crop.shape[1]}x{crop.shape[0]} at ({x0}, {y0})",
           "filtered_bytes": len(filt)}
    spent = []
    match_lengths = enc._match_lengths

    def timed(*args):
        t = time.perf_counter()
        r = match_lengths(*args)
        spent.append(time.perf_counter() - t)
        return r

    enc._match_lengths = timed
    try:
        t0 = time.perf_counter()
        tokens = enc.lz77_parse(np.frombuffer(filt, np.uint8))
        out["lz77_parse_ms"] = _ms(t0)
    finally:
        enc._match_lengths = match_lengths
    out["match_lengths_ms"] = sum(spent) * 1e3
    out["tokens"] = len(tokens)
    t0 = time.perf_counter()
    blob = enc.deflate(filt)
    out["deflate_ms"] = _ms(t0)
    if zlib.decompress(blob, -15) != filt:
        raise AssertionError("deflate does not decode to its input")
    out["deflate_bytes"] = len(blob)
    return out


def profile(rgba: np.ndarray, device="cuda", host_crop: int = HOST_CROP) -> dict:
    """Both encoders' phases: {"device": ..., "host": ...}."""
    return {"device": device_phases(rgba, device),
            "host": host_phases(rgba, host_crop)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("png", nargs="?",
                    help="a PNG (default: the synthetic corpus's first image)")
    ap.add_argument("--host-crop", type=int, default=HOST_CROP)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.png:
        with open(args.png, "rb") as f:
            rgba = decode_png(f.read(), inflate_fn=inflate_native)
    else:
        rgba = make_corpus()[0][2]
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    r = profile(rgba, dev, args.host_crop)
    d, hst = r["device"], r["host"]
    print(f"device encoder, {d['image']} RGBA, {d['filtered_bytes']} filtered "
          f"bytes:\n  deflate_fixed_device: {d['deflate_fixed_device_ms']:.1f} "
          f"ms -> {d['mbps']:.2f} MB/s, {d['deflate_bytes']} B\n"
          f"  select (lengths + walk + read-back): {d['select_ms']:.1f} ms, "
          f"{d['matches']} matches\n  parse: {d['parse_ms']:.1f} ms, "
          f"{d['tokens']} tokens\n  tokens_to_fields: "
          f"{d['tokens_to_fields_ms']:.1f} ms\n  pack_bits: "
          f"{d['pack_bits_ms']:.1f} ms", flush=True)
    print(f"host encoder, crop {hst['crop']}, {hst['filtered_bytes']} filtered "
          f"bytes:\n  lz77_parse: {hst['lz77_parse_ms']:.1f} ms "
          f"(_match_lengths {hst['match_lengths_ms']:.1f} ms), "
          f"{hst['tokens']} tokens\n  deflate: {hst['deflate_ms']:.1f} ms, "
          f"{hst['deflate_bytes']} B", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
