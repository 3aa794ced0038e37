"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
also printed as the last lines of standard error).  The run exits with a
code other than 0, and prints no result, where there is no CUDA card or
fewer than the cell asks for, where the program cannot be loaded, and
where JAX or the JAX package was loaded in the process.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    from benchmark import harness

    t_start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), device="cuda:0",
                                  t_start=t_start)
    except RuntimeError as e:
        print(f"run failed: {e}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}")
    print(json.dumps(result))
    for name, c in result["checks"].items():
        bound = "at least" if name == "calls_checked" else "at most"
        print(f"check {name} {c['value']} ({bound} {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
