#!/usr/bin/env python3
"""Where road_traffic's two kernels spend their time, and what each design
choice recorded for them in PERF.md costs, on one CUDA GPU.

    python3 tools/time_rt_kernels.py [--out rt_kernels.json]

On one road_traffic state (4096 envs x 20 vehicles, map 1, after 20
random steps) it times:

* the path-sweep kernel, built from ``vmas_tpu_torch/csrc/road_traffic.cu``
  as it is ("base") and as variants, each a text edit of the source, into
  the git-ignored ``vmas_tpu_torch/_build/variants/`` (one nvcc per variant,
  all started together). Every build also holds the group form at 4, 16
  and 32 threads per lane, beside the package's 1 and 8. The exact
  variants are the designs measured and dropped, each first held bitwise
  to the package's one-thread form at every group size:

  - ``divskip``: t = clamp(dot / ll, 0, 1) without the division where the
    clamp decides it (dot <= 0: 0; dot >= ll: 1);
  - ``sqgate``: the CG's and the centre line's roots taken only where the
    segment's squared distance could win (at most the best one's square);
  - ``lb8``: ``__launch_bounds__(128, 8)`` on the group kernel (at most 64
    registers a thread);
  - ``blk256``: blocks of 256 threads.

  Two probes give wrong results and only a share of the time:
  ``nostraddle`` (no rectangle-boundary straddle test) and ``nocorners``
  (no corner distance).
* the observation kernel, the package's build, at tile 0 (one thread per
  (env, ego)) and tiles of 1, 2, 4, 8 and 16 envs per block, each first
  held bitwise to tile 0.

Each form is timed (torch.profiler, 200 launches) in turns: every form,
then every form in reverse. Prints the card's name and power limit, each
variant's registers, stack and spills (``-Xptxas -v``), a table of
microseconds per launch and one JSON line. Needs one GPU.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

B, A, STEPS = 4096, 20, 20
LAUNCHES = 200
LANES = (1, 4, 8, 16, 32)
TILES = (0, 1, 2, 4, 8, 16)

# every build: the group form at each of LANES
ALL_LANES = [("  if (lanes == 8) return GROUP(8);",
              "".join(f"  if (lanes == {L}) return GROUP({L});\n" for L in LANES[1:]).rstrip("\n"))]
T_DIVIDED = "  float t = clamp01((pvx * vx + pvy * vy) / ll);"
CL_MIN = """      float d = seg_dist(a.x, a.y, svx, svy, ll, px, py);
      if (k == 0 || d < d_ref) {
        d_ref = d;
        i_ref = k;
      }"""
CG_MIN = """    float d = seg_dist(a.x, a.y, svx, svy, ll, qx[0], qy[0]);
    if (k == 0 || d < best[0]) {
      best[0] = d;
      bi = k;
    }"""
VARIANTS = {
    "base": [],
    "divskip": [(T_DIVIDED, "  float dot = pvx * vx + pvy * vy;\n"
                 "  float t = (ll < INFINITY && dot <= 0.0f) ? 0.0f\n"
                 "            : ((ll < INFINITY && dot >= ll) ? 1.0f : clamp01(dot / ll));")],
    "sqgate": [
        ("  float d_ref = INFINITY;\n  int i_ref = INT_MAX;",
         "  float d_ref = INFINITY, s_ref = INFINITY;\n  int i_ref = INT_MAX;"),
        ("  float d_ref = 0.0f;\n  int i_ref = 0;", "  float d_ref = 0.0f, s_ref = INFINITY;\n  int i_ref = 0;"),
        (CL_MIN, """      float sq = seg_sq(a.x, a.y, svx, svy, ll, px, py);
      if (k == 0 || sq <= s_ref) {
        float d = root(sq);
        if (k == 0 || d < d_ref) {
          d_ref = d;
          i_ref = k;
          s_ref = sq;
        }
      }"""),
        ("  int bi = INT_MAX;", "  int bi = INT_MAX;\n  float s0 = INFINITY;"),
        (CG_MIN, """    float sq0 = seg_sq(a.x, a.y, svx, svy, ll, qx[0], qy[0]);
    if (k == 0 || sq0 <= s0) {
      float d = root(sq0);
      if (k == 0 || d < best[0]) {
        best[0] = d;
        bi = k;
        s0 = sq0;
      }
    }"""),
    ],
    "lb8": [("__global__ void __launch_bounds__(kBlock)\nrt_sweep_group_kernel",
             "__global__ void __launch_bounds__(kBlock, 8)\nrt_sweep_group_kernel")],
    "blk256": [("constexpr int kBlock = 128;", "constexpr int kBlock = 256;")],
    "nostraddle": [("h = h || (c1 && c2);", "h = h || (c1 && c2 && k < 0);")],
    "nocorners": [("      if (k == 0 || sq < best[q]) best[q] = sq;", "      if (k < 0) best[q] = sq;")],
}
EXACT = ("base", "divskip", "sqgate", "lb8", "blk256")


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_us(fn, name):
    """Device us per call of ``fn`` in kernels whose name holds ``name``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and name in ev.name)
    if us <= 0:
        raise AssertionError(f"the profiler saw no {name}")
    return us / LAUNCHES


def ptxas_lines(log):
    """{kernel instantiation: 'registers, stack, spills'} from nvcc -Xptxas -v."""
    got = {}
    for part in log.split("Compiling entry function '")[1:]:
        m = re.search(r"(rt_\w+?_kernel)(?:ILi(\d+)E)?", part)
        regs = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", part)
        if m and regs and frame:
            key = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            got[key] = (f"{regs.group(1)} registers, {frame.group(1)} B stack, spill stores {frame.group(2)} B, "
                        f"loads {frame.group(3)} B")
    return got


def build_variants():
    """{variant: loaded library}, printing each one's registers per kernel."""
    from vmas_tpu_torch import _kernels

    src = (_kernels._CSRC / "road_traffic.cu").read_text()
    out = _kernels._BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in ALL_LANES + edits:
            if text.count(old) < 1:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for kern, line in ptxas_lines(log).items():
            if name == "base" or kern == "rt_sweep_group_kernel<8>":
                print(f"ptxas {name} {kern}: {line}", flush=True)
        libs[name] = _kernels.library("road_traffic", path=out / f"lib{name}.so")
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report as JSON to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_rt_kernels: no CUDA device; this tool runs on a GPU")
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

    card = card_line()
    print(card, flush=True)
    libs = build_variants()
    env = make_env("road_traffic", B, seed=0)
    for _ in range(STEPS):
        env.step(env.get_random_actions())
    sc, T, kw = env.scenario, env.scenario._sweep_tables, env.scenario.sweep_kw
    pid = env.state.scenario["path_id"].contiguous()
    pos, rot = (t.contiguous() for t in sc._agent_arrays(env.state)[:2])
    N, (NP, Mc, _), Mb = pid.numel(), T.center.shape, T.left.shape[1]

    def sweep(name, lanes):
        """One launch of variant ``name``'s sweep kernel (the wrapper's call)."""
        lib = libs[name]
        out = torch.empty((rtk.R_ST + 2 * kw["S"], N), dtype=torch.float32, device=pid.device)
        err = lib.vmas_rt_sweep(
            T.center.data_ptr(), T.left.data_ptr(), T.right.data_ptr(), T.meta.data_ptr(), NP, Mc, Mb,
            pid.data_ptr(), pos.data_ptr(), rot.data_ptr(), N, ctypes.c_float(kw["lh"]), ctypes.c_float(kw["wh"]),
            kw["S"], kw["interval"], kw["shift"], lanes, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {name} at {lanes} lanes: {lib.vmas_rt_error_string(err).decode()}")
        return out

    ref = rtk.sweep_rows(T, pid, pos, rot, lanes=1, **kw).view(torch.int32)
    for name in EXACT:
        for lanes in LANES:
            if not torch.equal(sweep(name, lanes).view(torch.int32), ref):
                raise AssertionError(f"variant {name} at {lanes} lanes differs from the package's one-thread form")
    print(f"exact variants {EXACT} at lanes {LANES} bitwise the package's one-thread form", flush=True)

    xs = sc.obs_inputs(env.state)
    obs = lambda tile: rtk.obs_all(*xs, **sc.obs_kw, tile=tile)
    oref = obs(0).view(torch.int32)
    for tile in TILES[1:]:
        if not torch.equal(obs(tile).view(torch.int32), oref):
            raise AssertionError(f"the observation kernel at tile {tile} differs from tile 0")
    print(f"observation tiles {TILES[1:]} bitwise tile 0; the rule picks tile "
          f"{rtk.obs_tile(A, kw['S'], sc.obs_kw['K'], pid.device)}", flush=True)

    forms = [("sweep", name, L) for name in VARIANTS for L in LANES] + [("obs", "base", t) for t in TILES]
    got = {f: [] for f in forms}
    for f in forms + forms[::-1]:
        kernel, name, x = f
        fn = (lambda: sweep(name, x)) if kernel == "sweep" else (lambda: obs(x))
        got[f].append(device_us(fn, "rt_sweep" if kernel == "sweep" else "rt_obs"))
    print(f"{'sweep variant':>14} " + " ".join(f"L{L:>2} fwd / rev us".rjust(22) for L in LANES))
    for name in VARIANTS:
        print(f"{name:>14} " + " ".join(f"{got[('sweep', name, L)][0]:10.3f} / {got[('sweep', name, L)][1]:9.3f}"
                                        for L in LANES))
    print("observations, tile: fwd / rev us: " + "; ".join(
        f"{t}: {got[('obs', 'base', t)][0]:.3f} / {got[('obs', 'base', t)][1]:.3f}" for t in TILES))
    report = {"card": card, "envs": B, "agents": A, "steps": STEPS, "launches": LAUNCHES,
              "sweep_us": {name: {str(L): got[("sweep", name, L)] for L in LANES} for name in VARIANTS},
              "obs_us": {str(t): got[("obs", "base", t)] for t in TILES}}
    print(json.dumps(report))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
