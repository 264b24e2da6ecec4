#!/usr/bin/env python3
"""Time the fused-step kernel of several source trees on one CUDA GPU.

    python3 tools/time_fused_step.py parent=_archive/parent change=. \\
        change_actptr=.:actptr

Each argument names a tree holding a ``vmas_tpu_torch`` package: ``label=path``
(relative to the repository root), or ``label=path:variant`` for a copy of
that tree (under ``_archive/variants/``) whose ``csrc/fused_step.cu`` is
changed: ``nounroll``, its pair loops lose their ``#pragma unroll 1``;
``actptr``, the kernel reads the in-kernel PID's ``ActParams`` through a
device pointer (copied to the card before each launch that runs the PID)
instead of taking them by value. The trees run in the
order given and then in reverse (A B C C B A), each in a process of its own
that imports its tree's package, builds its kernels and reports the kernel's
device time per launch (torch.profiler, 200 launches) for:

* transport, 4096 envs, 4 agents: the rows step and the fused step;
* balance, 4096 envs, 3 agents, and give_way, 4096 envs, 2 agents (the
  rows step with the in-kernel PID), where the tree has them: both forms;
* the all-pairs world (``vmas_tpu_torch.testing``), 4096 envs, where the
  tree has it: the fused step from its packed state.

States: each env after a reset and 5 random steps; the all-pairs world's
packed state from seed 4. Prints the card's name and power limit, one JSON
line per run, and a table of the mean per tree and form. Needs one GPU.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B = 4096
LAUNCHES = 200


def device_us(fn, n=LAUNCHES):
    """Device time per call of ``fn`` in kernels named fused_step_kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and "fused_step_kernel" in ev.name)
    if us <= 0:
        raise AssertionError("the profiler saw no fused_step_kernel")
    return us / n


def child(label):
    import numpy as np
    import torch

    import vmas_tpu_torch
    from vmas_tpu_torch import _kernels, make_env
    from vmas_tpu_torch.core import fused as F

    build_s = _kernels.build_all()
    dev = torch.device("cuda")
    out = {"label": label, "package": str(Path(vmas_tpu_torch.__file__).parent), "build_s": build_s, "us": {}}
    for name, kw in (("transport", {"n_agents": 4}), ("balance", {}), ("give_way", {})):
        try:
            env = make_env(name, B, device=dev, seed=0, fused_physics=True, **kw)
        except ValueError:
            continue  # not in this tree
        env.reset()
        for _ in range(5):
            env.step(env.get_random_actions())
        world, fo = env.world, env._fused_outputs
        slots = [a.index for a in env.agents]
        step = F.make_rows_step(world, fo, slots)
        carry = F.pack_carry(world, env.state, fo)
        gen = torch.Generator(device=dev).manual_seed(1)
        act = ((torch.rand((2 * len(slots), B), generator=gen, device=dev) * 2 - 1) * 0.6).contiguous()
        extra = torch.empty((fo.n_out + getattr(fo, "n_ctrl_out", 0), B), device=dev)
        x = carry[:carry.shape[0] - getattr(fo, "n_ctrl", 0)].clone()  # the fused form carries no controller rows
        out["us"][f"rows_step[{name}]"] = device_us(lambda: step(carry, act, extra))
        out["us"][f"fused_step[{name}]"] = device_us(lambda: F.fused_step(world, x, fo))
        del env
    try:
        import vmas_tpu_torch.core as TC
        from vmas_tpu_torch.interop import state_from_numpy
        from vmas_tpu_torch.testing import all_pairs_state, all_pairs_world
    except ImportError:
        pass  # not in this tree
    else:
        aw = all_pairs_world(TC, B, dev)
        xa = F.state_rows(state_from_numpy(aw, all_pairs_state(np.random.default_rng(4), B))).contiguous()
        out["us"]["fused_step[all_pairs]"] = device_us(lambda: F.fused_step(aw, xa))
    print(json.dumps(out), flush=True)


def _nounroll(src):
    src, n = re.subn(r"[ \t]*#pragma unroll 1\n(?=[ \t]*for \(int k = 0; k < sp\.n_)", "", src)
    if n == 0:
        raise SystemExit("no pair loop with '#pragma unroll 1'")
    return src


_ACTPTR = [
    ("const ActParams ap, const int* __restrict__ tab,",
     "const ActParams* __restrict__ app, const int* __restrict__ tab,"),
    ("  const int n_ctrl = ROWS ? 4 * ap.n_pid : 0;",
     "  const int n_pid = ROWS && app ? app->n_pid : 0;\n  const int n_ctrl = 4 * n_pid;"),
    ("if (ap.n_pid) pid_act(ap, fx, fy, vx, vy, ctrl, blk + (size_t)(n_tot - 2 * ap.n_pid) * B, B, b);",
     "if (n_pid) pid_act(*app, fx, fy, vx, vy, ctrl, blk + (size_t)(n_tot - 2 * n_pid) * B, B, b);"),
    ("(*spec, *ep, *ap, tab,", "(*spec, *ep, dap, tab,"),
    ("  cudaStream_t s = static_cast<cudaStream_t>(stream);\n",
     "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
     "  const ActParams* dap = nullptr;\n"
     "  if (ap->n_pid) {\n"
     "    static ActParams* buf = nullptr;\n"
     "    if (!buf && cudaMalloc(&buf, sizeof(ActParams)) != cudaSuccess) return cudaErrorMemoryAllocation;\n"
     "    cudaMemcpyAsync(buf, ap, sizeof(ActParams), cudaMemcpyHostToDevice, s);\n"
     "    dap = buf;\n"
     "  }\n"),
]


def _actptr(src):
    for old, new in _ACTPTR:
        if src.count(old) != 1:
            raise SystemExit(f"not once in fused_step.cu: {old!r}")
        src = src.replace(old, new)
    return src


VARIANTS = {"nounroll": _nounroll, "actptr": _actptr}


def tree_of(spec):
    """(label, tree path) of ``label=path[:variant]``, making the variant."""
    label, _, rest = spec.partition("=")
    path, _, variant = rest.partition(":")
    tree = (ROOT / path).resolve()
    if not variant:
        return label, tree
    if variant not in VARIANTS:
        raise SystemExit(f"unknown variant {variant!r}")
    dst = ROOT / "_archive" / "variants" / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / "vmas_tpu_torch", dst / "vmas_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = dst / "vmas_tpu_torch" / "csrc" / "fused_step.cu"
    cu.write_text(VARIANTS[variant](cu.read_text()))
    return label, dst


def main():
    if "--child" in sys.argv:
        return child(sys.argv[sys.argv.index("--child") + 1])
    import torch

    if not torch.cuda.is_available():
        print("time_fused_step: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = [tree_of(a) for a in sys.argv[1:]]
    runs = []
    for label, tree in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=str(tree))
        res = subprocess.run([sys.executable, __file__, "--child", label], cwd=tree, env=env,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise SystemExit(f"{label}: the run failed")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        if not line["package"].startswith(str(tree)):
            raise SystemExit(f"{label}: imported {line['package']}, not the tree's package")
        print(json.dumps(line), flush=True)
        runs.append(line)
    forms = sorted({f for r in runs for f in r["us"]})
    print(f"device us per launch, mean of each tree's runs ({card}):")
    print("tree".ljust(20) + "".join(f.rjust(24) for f in forms))
    for label, _ in trees:
        mine = [r["us"] for r in runs if r["label"] == label]
        cells = [sum(m[f] for m in mine) / len(mine) if all(f in m for m in mine) else None for f in forms]
        print(label.ljust(20) + "".join(("-" if c is None else f"{c:.3f}").rjust(24) for c in cells))


if __name__ == "__main__":
    main()
