#!/usr/bin/env python3
"""Readings of a cell's compared numbers over many seeds in one process, for
setting its limits (``limits/<cell>.json``): the program as the cell runs it,
with ``--control`` the control (the program's lower-precision path where it
has one, else the reference's), or with ``--fault`` the program with one of
``faults.py``'s faults planted, at the cell's own sizes.

    python3 benchmark_port/readings.py --workload <cell> --seeds 1 2 3 [--control]
        [--fault <name>] [--out chiprun_out/readings.jsonl]

Each seed builds the cell's job anew (weights, inputs and draws from that
seed), runs the units that the check samples through the timed path, frees
the program and runs the check.  One JSON line per seed.  Card only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(run.ROOT))
    cell = run.Cell(json.loads((run.ROOT / "BENCHMARK.json").read_text()), args.workload)
    driver = cell.piece(f"drivers/{cell.traffic['driver']}")
    device = torch.device("cuda")
    if args.fault:
        run.load("faults").plant(args.fault)
    for seed in args.seeds:
        t0 = time.perf_counter()
        job = driver.Job(cell, seed, device, control=args.control)
        job.run_sampled()
        torch.cuda.synchronize()
        job.free()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed, "control": args.control,
                "fault": args.fault,
                "readings": job.check(), "seconds": time.perf_counter() - t0,
                "card": run.power_limit()}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del job
        torch.cuda.empty_cache()
    found = run.forbidden_modules()
    if found:
        print(f"JAX modules loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
