#!/usr/bin/env python3
"""What the program's spans (``vmas_tpu_torch.profiling.span``) cost, and
what they read with and without the profiler, on one CUDA GPU.

    python3 tools/time_spans.py --seed <n> [--out spans.json]

After the card's name and power limit it reports:

1. the cost of one span site (``with span(...)`` around nothing, against
   the same loop without it; the least of 5 loops): off (the default: one
   flag check), enabled by ``profiling.enable()`` on the host clock,
   enabled on the device's clock (a CUDA event pair), and under a
   ``torch.profiler`` session with CPU and CUDA activities;
2. for each benchmark cell (``BENCHMARK.json``, built as ``portbench``
   builds it, from the seed), one stretch of its traced length (10
   rollout calls, 2 PPO updates) three times: the recorder off, enabled
   outside the profiler, and under the profiler (the recorder off, as in
   a ``--trace 1`` run). Each stretch's CUDA-event seconds, and for the
   last two the cell's span metrics (``portbench/metrics/``), the parent
   spans and the share of each parent its parts cover.

One JSON object per part on standard output; with ``--out`` the whole
report is also written to that file.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SITE = "vmas.test.site"
PARTS = {"vmas.ppo.update": ("vmas.ppo.collect", "vmas.ppo.batch", "vmas.ppo.fit"),
         "vmas.rows.call": ("vmas.rows.actions", "vmas.rows.loop", "vmas.rows.finish")}


def site_cost(n, device=False, profiled=False, enabled=False):
    """Microseconds a span site adds, the least over 5 loops of ``n``."""
    import torch

    from vmas_tpu_torch import profiling

    def loop(with_span):
        t0 = time.perf_counter()
        if with_span:
            for _ in range(n):
                with profiling.span(SITE, device=device):
                    pass
        else:
            for _ in range(n):
                pass
        if device:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    best = []
    for _ in range(5):
        profiling.reset()
        profiling.enable(enabled)
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]):
                t_span = loop(True)
                t_bare = loop(False)
        else:
            t_span = loop(True)
            t_bare = loop(False)
        best.append((t_span - t_bare) / n * 1e6)
    profiling.enable(False)
    profiling.reset()
    return min(best)


def readings(cell, kind):
    """The cell's span metrics, the parent spans and their parts' cover."""
    from portbench import harness as H
    from vmas_tpu_torch import profiling

    s = profiling.summary()
    out = {m["name"]: H.read_metric(cell, m, {"kind": kind}) for m in cell.per_layer
           if m["source"] == "program_span" and not m["name"].startswith(("mfu", "collect_ms", "fit_ms"))}
    for parent, parts in PARTS.items():
        if parent not in s:
            continue
        p = s[parent]
        out[parent] = {"count": p["count"], "host_ms": p["samples_ms"], "device_ms": p.get("device_ms")}
        if all(k in s for k in parts):
            out[parent]["parts_host_share"] = sum(s[k]["total_s"] for k in parts) / p["total_s"]
            if p.get("device_ms") and all(s[k].get("device_ms") for k in parts):
                out[parent]["parts_device_share"] = (sum(sum(s[k]["device_ms"]) for k in parts)
                                                     / sum(p["device_ms"]))
    out["counts"] = {k: v["count"] for k, v in s.items()}
    return out


def stretches(cell, fn, n, kind):
    """``fn()`` ``n`` times, three ways -> the report of each."""
    import torch

    from vmas_tpu_torch import profiling
    from vmas_tpu_torch.core import fused as F

    def timed():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        launches0 = F.rows_step_launches
        ev[0].record()
        for _ in range(n):
            fn()
        ev[1].record()
        ev[1].synchronize()
        return {"seconds": ev[0].elapsed_time(ev[1]) / 1e3, "launches": F.rows_step_launches - launches0}

    report = {}
    profiling.enable(False)
    profiling.reset()
    report["off"] = timed()
    profiling.enable()
    report["enabled"] = timed()
    profiling.enable(False)
    report["enabled"].update(readings(cell, kind))
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        report["traced"] = timed()
    report["traced"].update(readings(cell, kind))
    profiling.reset()
    report["enabled_cost"] = report["enabled"]["seconds"] / report["off"]["seconds"] - 1
    return report


def rollout_cell(cell, seed, device):
    import torch

    from portbench import harness as H
    from vmas_tpu_torch.parallel.rollout import rows_rollout_fn

    s_init, s_run = H.seeds(seed)
    env, _ = H.make_program_env(cell, device)
    init = cell.reference.initial_state(cell.num_envs, torch.Generator(device=device).manual_seed(s_init), device)
    run_fn = rows_rollout_fn(env, horizon=cell.traffic["horizon"])
    gen = torch.Generator(device=device).manual_seed(s_run)
    cur = {"state": H.program_state(env, init), "steps": env.steps}

    def call():
        cur["state"], cur["steps"], _ = run_fn(cur["state"], cur["steps"], gen)

    for _ in range(cell.traffic["warm_calls"]):
        call()
    return stretches(cell, call, cell.traffic["trace_calls"], "rollout")


def ppo_cell(cell, seed, device):
    p = cell.runner.setup_program(cell, seed, device)

    def update():
        p["state"], p["steps"], _ = p["update"](p["model"], p["opt"], p["state"], p["steps"], p["gen"])

    for _ in range(cell.traffic["check_updates"]):
        update()
    return stretches(cell, update, cell.traffic["trace_updates"], "ppo")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True, help="makes every input of the cells")
    ap.add_argument("--sites", type=int, default=200000, help="span sites a loop of the cost part")
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()

    import torch

    from portbench import harness as H

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.set_num_threads(1)
    report = {"card": H.card_line(), "torch": torch.__version__}
    print(json.dumps(report), flush=True)
    cost = {"off": site_cost(args.sites), "enabled_host": site_cost(args.sites, enabled=True),
            "enabled_device": site_cost(args.sites // 10, device="cuda", enabled=True),
            "profiled_host": site_cost(args.sites // 10, profiled=True)}
    report["site_us"] = cost
    print(json.dumps({"site_us": cost}), flush=True)
    for name, build in (("joint_passage.rollout", rollout_cell), ("transport.ppo", ppo_cell)):
        cell = H.load_cell(name, ROOT)
        report[name] = build(cell, args.seed, "cuda:0")
        print(json.dumps({name: report[name]}), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
