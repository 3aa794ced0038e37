"""cuda_gz: gzip decode/encode on the card (the port of cli/tpu_gz.py;
parity target the reference's hellogz.c).

  python -m debigulator_tpu_torch.cli.cuda_gz decode file.gz [-o out]
      [--host] [--repeat N] [--no-verify] [--trace [LOGDIR]] [--device D]
  python -m debigulator_tpu_torch.cli.cuda_gz encode file [-o out.gz]

--repeat N reproduces hellogz.c's stress loop (hellogz.c:64-74) as a
throughput measurement.  --device defaults to cuda; --device cpu runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
import time

from debigulator_tpu_torch.utils.profiling import DEFAULT_LOGDIR


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_gz")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="a decode's time by layer (-v) / a line a span (-vv)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode")
    d.add_argument("file")
    d.add_argument("-o", "--output")
    d.add_argument("--host", action="store_true", help="host oracle path")
    d.add_argument("--repeat", type=int, default=1)
    d.add_argument("--no-verify", action="store_true")
    d.add_argument("--trace", metavar="LOGDIR", nargs="?",
                   const=DEFAULT_LOGDIR,
                   help="capture a torch.profiler trace around the "
                        "steady-state decode and print the top ops (and, "
                        "on the card, the kernels)")
    d.add_argument("--device", default="cuda",
                   help="device of the decode (default cuda)")
    e = sub.add_parser("encode")
    e.add_argument("file")
    e.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    if args.verbose:
        from debigulator_tpu_torch.utils.config import get_config

        get_config().verbosity = max(get_config().verbosity, args.verbose)

    if args.cmd == "decode":
        data = Path(args.file).read_bytes()
        verify = not args.no_verify
        if args.host:
            from debigulator_tpu_torch.models.gzip_codec import decode_gzip

            def fn():
                return decode_gzip(data, verify=verify)
        else:
            from debigulator_tpu_torch.models.pipeline import decode_gzip_device

            def fn():
                return decode_gzip_device(data, verify=verify,
                                          device=args.device)
        t0 = time.time()
        out = fn()
        first = time.time() - t0
        if args.trace:
            from debigulator_tpu_torch.utils.profiling import (
                device_trace,
                trace_kernel_summary,
                trace_op_summary,
            )

            with device_trace(args.trace, device=args.device) as logdir:
                out = fn()
            sys.stderr.write(f"trace written to {logdir}; top ops:\n")
            for ms, name in trace_op_summary(logdir, top=10):
                sys.stderr.write(f"  {ms:9.2f} ms  {name}\n")
            # On the card: every kernel, however short its launches (one
            # stream's run microseconds, under the top-ops list's cut).
            kernels = trace_kernel_summary(logdir, top=None)
            if kernels:
                sys.stderr.write("device kernels:\n")
            for ms, n, name in kernels:
                sys.stderr.write(f"  {ms:9.4f} ms  {n:3d}x  {name[:100]}\n")
        if args.repeat > 1:
            t0 = time.time()
            for _ in range(args.repeat - 1):
                out = fn()
            dt = (time.time() - t0) / (args.repeat - 1)
        else:
            dt = first
        sys.stderr.write(
            f"{args.file}: {len(data)} -> {len(out)} bytes; "
            f"first {first*1e3:.1f} ms, steady {dt*1e3:.1f} ms "
            f"({len(out)/dt/1e6:.1f} MB/s out)\n"
        )
        if args.output:
            Path(args.output).write_bytes(out)
        else:
            sys.stdout.buffer.write(out[:4096])
        return 0

    data = Path(args.file).read_bytes()
    from debigulator_tpu_torch.models.gzip_codec import encode_gzip

    t0 = time.time()
    blob = encode_gzip(data, fname=args.file.rsplit("/", 1)[-1].encode())
    dt = time.time() - t0
    out_path = args.output or args.file + ".gz"
    Path(out_path).write_bytes(blob)
    sys.stderr.write(
        f"{args.file}: {len(data)} -> {len(blob)} bytes "
        f"({len(blob)/max(len(data),1):.3f}x) in {dt*1e3:.1f} ms -> {out_path}\n"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
