"""One run of one cell: set-up, the measured window (or, with ``--trace 1``,
the traced stretches), the check against the plain reference, and the
result as the last line of standard output."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from portbench import harness as H


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench", description=__doc__)
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json's workloads")
    ap.add_argument("--seed", type=int, required=True, help="makes every input of the run")
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: the per-layer metrics from a traced run instead of the end-to-end ones")
    return ap.parse_args(argv)


def main(argv, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    # a library that would load JAX by itself is kept from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # the host's load is this one process on one thread: the work is on the
    # card, and idle worker threads of the host's thread pools would take
    # cycles from the thread that launches it
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    root = Path.cwd()
    if not (root / "BENCHMARK.json").exists():
        print("no BENCHMARK.json here: run from the root of a checkout", file=sys.stderr)
        return 2
    cell = H.load_cell(args.workload, root)
    chips = int(cell.workload["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(f"card: {H.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    torch.cuda.reset_peak_memory_stats()
    return run_cell(cell, args, "cuda:0", t_start)


def run_cell(cell, args, device, t_start):
    """Everything of a run after the look for a chip: the runner's set-up,
    window and check, the look for forbidden modules, and the result line.
    Returns the exit code."""
    import torch

    res = cell.runner.run(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    found = H.forbidden_modules()
    if found:
        print(f"the run loaded modules it may not: {found}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = H.read_metric(cell, m, res["readings"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]} for m in cell.e2e}
    on_card = str(device).startswith("cuda")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(cell.workload["chips"]), "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if args.trace:
        device_info.update(busy_s=res["readings"]["busy_s"], window_s=res["readings"]["window_s"])
    line = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]), "failed": int(res["failed"]),
            "metrics": metrics, "device": device_info}
    if args.trace and res.get("breakdown"):
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
