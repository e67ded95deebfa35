"""The check's control, and its lower readings, on the card.

    python3 -m loam_bench.control --workload <cell> --seconds <s>
        --tf32 <0|1> --seeds <n> ...

For each seed, in one process (the graphs captured once, with TF32 as
asked): the cell's set-up, a window of ``--seconds`` and the check. With
``--tf32 1`` the program runs its float32 matrix products in TF32, the
precision below the configuration's float32 with TF32 off: the control.
A graph keeps the matrix-product kernels it was captured with, so the
program and the control run in separate processes. Prints one JSON line a
seed with the numbers compared. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from loam_bench import spec
from loam_bench.run import run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m loam_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tf32", type=int, choices=(0, 1), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = spec.plan(args.workload)
    for seed in args.seeds:
        out = run_cell(cell, seed, args.seconds, False,
                       torch.device("cuda", 0), time.time(),
                       control=bool(args.tf32))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "tf32": args.tf32,
                          "numbers": {k: v["value"] for k, v in
                                      out["result"]["checks"].items()},
                          "correct": out["result"]["correct"],
                          "samples": out["samples"],
                          "check_s": out["check_s"],
                          "metrics": out["result"]["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
