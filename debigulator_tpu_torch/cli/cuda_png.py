"""cuda_png: PNG decode/encode/round-trip on the card (the port of
cli/tpu_png.py; parity target the reference's hellopng.c).

  python -m debigulator_tpu_torch.cli.cuda_png decode a.png b.png ...
      [--host] [--preview] [--bench] [--device D]
  python -m debigulator_tpu_torch.cli.cuda_png encode raw.rgba WxH -o out.png
      [--device D]
  python -m debigulator_tpu_torch.cli.cuda_png roundtrip a.png ... [--device D]

--device (default cuda) is where the decode runs, and where encode and
roundtrip run their filter search; --device cpu runs the plain versions.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_png")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="a decode's time by layer (-v) / a line a span (-vv)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode")
    d.add_argument("files", nargs="+")
    d.add_argument("--host", action="store_true")
    d.add_argument("--preview", action="store_true")
    d.add_argument("--bench", action="store_true")
    e = sub.add_parser("encode")
    e.add_argument("raw")
    e.add_argument("size", help="WxH")
    e.add_argument("-o", "--output", required=True)
    r = sub.add_parser("roundtrip")
    r.add_argument("files", nargs="+")
    for p in (d, e, r):
        p.add_argument("--device", default="cuda",
                       help="device of the decode / filter search "
                            "(default cuda)")
    args = ap.parse_args(argv)
    if args.verbose:
        from debigulator_tpu_torch.utils.config import get_config

        get_config().verbosity = max(get_config().verbosity, args.verbose)

    from debigulator_tpu_torch.models import png_codec
    from debigulator_tpu_torch.utils.preview import ascii_preview, summary

    if args.cmd == "decode":
        if not args.host:
            from debigulator_tpu_torch.models.pipeline import decode_png_device

            def dec(data):
                return decode_png_device(data, device=args.device)
        else:
            dec = png_codec.decode_png
        total_bytes, t_all = 0, 0.0
        for f in args.files:
            data = Path(f).read_bytes()
            t0 = time.time()
            rgba = dec(data)
            dt = time.time() - t0
            total_bytes += rgba.nbytes
            t_all += dt
            sys.stderr.write(f"{f}: {summary(rgba)} in {dt*1e3:.1f} ms\n")
            if args.preview:
                print(ascii_preview(rgba))
        if args.bench:
            sys.stderr.write(
                f"total: {total_bytes/1e6:.1f} MB RGBA in {t_all*1e3:.1f} ms "
                f"= {total_bytes/t_all/1e6:.1f} MB/s\n"
            )
        return 0

    if args.cmd == "encode":
        w, h = map(int, args.size.lower().split("x"))
        raw = np.fromfile(args.raw, np.uint8)
        ch = raw.size // (w * h)
        rgba = raw.reshape(h, w, ch)
        t0 = time.time()
        blob = png_codec.encode_png(rgba, device=args.device)
        sys.stderr.write(
            f"{args.raw}: {raw.size} -> {len(blob)} bytes in "
            f"{(time.time()-t0)*1e3:.1f} ms -> {args.output}\n"
        )
        Path(args.output).write_bytes(blob)
        return 0

    # roundtrip
    ok = True
    for f in args.files:
        data = Path(f).read_bytes()
        rgba = png_codec.decode_png(data)
        blob = png_codec.encode_png(rgba, device=args.device)
        rgba2 = png_codec.decode_png(blob)
        good = bool((rgba == rgba2).all())
        ok &= good
        sys.stderr.write(
            f"{f}: {'RGBA-bit-exact' if good else 'MISMATCH'} "
            f"({len(data)} -> {len(blob)} bytes)\n"
        )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
