"""The control of a cell's check: the reference put in the program's place,
one precision below the configuration's (bfloat16 inputs for float32,
float32 for float64), driven through the cell's own traffic, set-up and
check. Its numbers are the upper readings the limits are set below; a
benchmark run never runs it.

    python3 -m spmv_bench.control --workload <cell> --seeds 1,2,3 --seconds 3

One JSON line per seed: the numbers compared, their limits, and whether
the control came out correct (it must not).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run.run_cell(cell, seed, args.seconds, False, "cuda:0", time.perf_counter(), system="control")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
