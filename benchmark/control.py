"""The control of the comparison that decides ``correct``: the reference,
put in the program's place, one bit short of the exact decode that the
configurations guarantee.  It has to come out as not correct.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...] --seconds <s>

runs the cell's set-up and a short window once a seed with the control
in the program's place, and prints one JSON line a seed with the numbers
compared and ``correct``.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness, reference


def control_entry(pool) -> harness.Entry:
    """An entry that answers every call with ``reference.control`` of the
    pool item it was given."""
    by_args = {id(item.args): item for item in pool}

    def call(args, device):
        return reference.control(by_args[id(args)])

    return harness.Entry(call, list)


def run_control(cell: harness.Cell, seed: int, seconds: float,
                device="cuda") -> dict:
    """One run of ``cell`` with the control in the program's place."""
    return harness.run_cell(
        cell, seed, seconds, False, device=device,
        call_for=control_entry)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        r = run_control(cell, seed, args.seconds, device="cuda:0")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
