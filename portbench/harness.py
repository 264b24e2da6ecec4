"""What every cell shares: finding a cell's files by name, the program's
environment and state, the window, the profiler's reading and the result.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its files:

* ``portbench/cells/<cell>.json``: its size (``num_envs``) and the limit of
  each number its check compares;
* ``portbench/configs/<config>.json``: the scenario and its keyword
  arguments as the program runs them, the source, what was assumed and
  reduced; ``portbench/configs/<config>.py``: the configuration's plain
  reference (world table, initial state, emit);
* ``portbench/traffic/<traffic>.json``: the traffic's parameters and the
  runner (``portbench/runners/<runner>.py``) that runs them;
* ``portbench/metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

PKG = Path(__file__).resolve().parent
# the third-party and program modules no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "vmas_tpu")


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path, bench_dir: Path = PKG) -> SimpleNamespace:
    """Cell ``name`` of ``root/BENCHMARK.json`` with its configuration, traffic
    and size read from their files under ``bench_dir``, and the metrics of
    ``BENCHMARK.json`` that it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    size = json.loads((bench_dir / "cells" / f"{name}.json").read_text())

    def in_cell(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if in_cell(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if in_cell(m) and m["moves"] in e2e_names]
    return SimpleNamespace(
        name=name, workload=w, config=config, traffic=traffic, num_envs=int(size["num_envs"]),
        limits=size["limits"], e2e=e2e, per_layer=per_layer, bench_dir=bench_dir,
        reference=load_module(bench_dir / "configs" / f"{w['config']}.py", f"portbench_config_{w['config']}"),
        runner=load_module(bench_dir / "runners" / f"{traffic['runner']}.py", f"portbench_runner_{traffic['runner']}"),
    )


def read_metric(cell, metric: dict, readings: dict):
    """The per-layer metric's value from its reader, or None where the
    reader finds nothing to read."""
    mod = load_module(cell.bench_dir / "metrics" / f"{metric['name']}.py", "portbench_metric_" + metric["name"])
    return mod.read(readings)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# -- the program's environment and state ---------------------------------------

def make_program_env(cell, device):
    """The program's environment for the cell (its ``make_env`` and first
    reset), and the host seconds they took."""
    from vmas_tpu_torch import make_env

    t0 = time.perf_counter()
    env = make_env(cell.config["scenario"], num_envs=cell.num_envs, device=device, seed=0, fused_physics=True,
                   **cell.config["kwargs"])
    seconds = time.perf_counter() - t0
    names = [e.name for e in env.world.entities]
    if names != cell.reference.ENTITY_NAMES:
        raise RuntimeError(f"the program's entities {names} are not the configuration's "
                           f"{cell.reference.ENTITY_NAMES}")
    return env, seconds


def program_state(env, init):
    """The program's state holding the benchmark's initial state ``init``
    (the per-entity fields and the scenario scratch the reference made),
    handed over through the program's interop."""
    from vmas_tpu_torch.interop import state_onto, state_to_tensors

    arrays = state_to_tensors(env.state)
    for f in ("pos", "vel", "rot", "ang_vel", "force", "torque", "joint_fixed_rot"):
        if f in init:
            arrays[f] = init[f]
    for k, v in init["scenario"].items():
        arrays["scenario"][k] = v
    return state_onto(env.state, arrays)


def seeds(seed: int):
    """The seeds of a run's two inputs: the initial state and weights, and
    the generator the program draws its actions from."""
    return seed, seed ^ 0x5DEECE66D


def sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def window(call, seconds, device):
    """``call()`` back to back for ``seconds`` -> (calls completed, the
    window's seconds, which end in a device sync). The quartiles of the
    calls' host seconds go on standard error (each from the host's return
    from one call to its return from the next: the host may run ahead of
    the device, so they spread more than device times)."""
    import statistics

    ends = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        call()
        ends.append(time.perf_counter())
    sync(device)
    window_s = time.perf_counter() - t0
    each = [b - a for a, b in zip([t0] + ends, ends)]
    q = statistics.quantiles(each, n=4) if len(each) > 1 else each * 3
    print(f"calls' host seconds: quartiles {q[0]:.6f} {q[1]:.6f} {q[2]:.6f}, min {min(each):.6f}, "
          f"max {max(each):.6f}", file=sys.stderr, flush=True)
    return len(ends), window_s


# -- the profiler ---------------------------------------------------------------

PROFILE_TRIES = 4
# a device operation's name in the breakdown, cut to its head (kernels of
# templates carry their whole signature)
NAME_CHARS = 120


def profile(fn, device):
    """Run ``fn()`` under torch.profiler (host and device activity) and
    return ``(device intervals [(start_us, end_us, name)], host events
    [(start_us, end_us, name)], wall seconds)``. CUPTI now and then hands
    back a session with no device record; such a session is taken again,
    up to ``PROFILE_TRIES`` in all (``fn`` runs once per session)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for attempt in range(1, PROFILE_TRIES + 1):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(device)
            wall = time.perf_counter() - t0
        dev, host = [], []
        for ev in prof.events():
            r = (ev.time_range.start, ev.time_range.end, ev.name)
            (dev if ev.device_type == DeviceType.CUDA else host).append(r)
        if dev:
            return dev, host, wall
        print(f"profiler session {attempt} of {PROFILE_TRIES} saw no device record", file=sys.stderr, flush=True)
    return [], [], wall


def union(intervals):
    """The disjoint union of ``(start, end, ...)`` intervals, sorted."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def trace_summary(dev, host, wall, top=10):
    """From a profiled stretch: the seconds in which some device operation
    ran (the union of their intervals, so overlapping streams count once),
    the count of device operations, the device operations that took most
    time and the idle gaps between device activity by the innermost host
    operation running at the gap's midpoint, each as ``[name, seconds]``."""
    busy = union(dev)
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_name = {}
    for s, e, name in dev:
        name = name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    gaps = {}
    spans = sorted(host)
    starts = [h[0] for h in spans]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(starts, mid)
        # the host operations open at the midpoint, among the last few
        # hundred that began before it
        inner = [h for h in spans[max(0, i - 500):i] if h[1] >= mid]
        name = min(inner, key=lambda h: h[1] - h[0])[2][:NAME_CHARS] if inner else "(host outside any operation)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy_s, "window_s": wall, "device_ops": len(dev),
            "breakdown": {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}}


def kernel_time(dev, kernel: str):
    """(launches, device seconds) of the device operations whose name holds
    ``kernel``."""
    hits = [(e - s) / 1e6 for s, e, name in dev if kernel in name]
    return len(hits), sum(hits)


# -- the check ------------------------------------------------------------------

def checks_of(readings: dict, limits: dict):
    """``{name: {"value", "limit"}}`` for every compared number, and whether
    each is within its limit; a reading that is not a finite number (a
    NaN where the program's output was) is given as None and fails."""
    import math

    checks = {k: {"value": float(v) if math.isfinite(v) else None, "limit": float(limits[k])}
              for k, v in readings.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return checks, ok
