"""The controls of the correctness check, read on the card at a cell's own
size: the plain reference put in the program's place and computed with
float8 e4m3 products (the control), and, for a training cell, the
reference with half of each batch left out and the mean taken over the
rest.  Each prints the numbers the cell's check compares, beside its
limits; the benchmark's own runs never run these.

    python -m bench_h100.control --workload <cell> --seeds 11,22,33 [--fault half_batch]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .run import cell_spec, make_cell


def readings(spec: dict, seed: int, device, fault: str = "fp8") -> dict:
    """The check's numbers with the control (or ``fault``) in the
    program's place."""
    cell = make_cell(spec, seed, device)
    if fault == "fp8":
        return cell.check(spec["tr"].get("check_calls", 1), fp8=True)
    if fault == "half_batch":
        return cell.check_half_batch()
    raise ValueError(fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="fp8", choices=("fp8", "half_batch"))
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(spec, seed, "cuda", args.fault)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "readings": r, "limits": spec["limits"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
