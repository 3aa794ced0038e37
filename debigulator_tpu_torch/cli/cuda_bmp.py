"""cuda_bmp: BMP decode/encode (the port of cli/tpu_bmp.py; parity target
the reference's hellobmp.c).

  python -m debigulator_tpu_torch.cli.cuda_bmp roundtrip a.bmp [-o out.bmp]
  python -m debigulator_tpu_torch.cli.cuda_bmp info a.bmp

BMP has no compressed payload: the codec runs on the host in both
packages, so this front end takes no --device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_bmp")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="decode summaries (-v) / phase debug (-vv)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("roundtrip")
    r.add_argument("file")
    r.add_argument("-o", "--output")
    i = sub.add_parser("info")
    i.add_argument("file")
    args = ap.parse_args(argv)
    if args.verbose:
        from debigulator_tpu_torch.utils.config import get_config

        get_config().verbosity = max(get_config().verbosity, args.verbose)

    from debigulator_tpu_torch.models import bmp_codec
    from debigulator_tpu_torch.utils.preview import summary

    data = Path(args.file).read_bytes()
    if args.cmd == "info":
        w, h = bmp_codec.get_bmp_width_height(data)
        print(f"{args.file}: {w}x{h}")
        return 0
    img = bmp_codec.decode_bmp(data)
    blob = bmp_codec.encode_bmp(img)
    img2 = bmp_codec.decode_bmp(blob)
    good = bool((img == img2).all())
    sys.stderr.write(
        f"{args.file}: {summary(img)} roundtrip="
        f"{'bit-exact' if good else 'MISMATCH'}\n"
    )
    if args.output:
        Path(args.output).write_bytes(blob)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
