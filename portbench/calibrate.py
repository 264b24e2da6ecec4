"""Readings that set a cell's limits, at the cell's own size on the card:
the program's compared numbers on many seeds (sound runs, a short window
each), the lower-precision control's, and each planted fault's. One JSON
line per reading on standard output.

    python3 -m portbench.calibrate --workload joint_passage.rollout \\
        --seeds 11 12 13 --control-seeds 21 22 23 --fault-seeds 31 32 33
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from portbench import faults
from portbench import harness as H


def main(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=list(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = H.load_cell(args.workload, Path.cwd())

    import torch

    if not torch.cuda.is_available():
        print("calibration reads the card: no CUDA device", file=sys.stderr)
        return 2
    device = "cuda:0"
    print(f"card: {H.card_line()}", file=sys.stderr, flush=True)

    def emit(what, seed, readings, **extra):
        print(json.dumps({"cell": cell.name, "what": what, "seed": seed, "readings": readings, **extra}), flush=True)

    def program(seed):
        res = cell.runner.run(cell, seed, args.seconds, False, device, time.perf_counter())
        torch.cuda.empty_cache()
        return {k: c["value"] for k, c in res["checks"].items()}, res["e2e"]

    for seed in args.seeds:
        readings, e2e = program(seed)
        emit("program", seed, readings, e2e=e2e)
    for seed in args.control_seeds:
        emit("control", seed, cell.runner.control(cell, seed, device))
        torch.cuda.empty_cache()
    for kind in args.faults if args.fault_seeds else ():
        for seed in args.fault_seeds:
            with faults.planted(kind, cell):
                readings, _ = program(seed)
            emit(f"fault:{kind}", seed, readings)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
