#!/usr/bin/env python3
"""Time the fused-step kernel of several source trees on one CUDA GPU.

    git archive HEAD~1 vmas_tpu_torch | tar -x -C _archive/parent  # the parent
    python3 tools/time_fused_step.py parent=_archive/parent change=.
    python3 tools/time_fused_step.py --worlds simple,dropout --lanes 1,8 parent=_archive/parent change=.

Each argument names a tree holding a ``vmas_tpu_torch`` package: ``label=path``
(relative to the repository root), or ``label=path:variant`` for a copy of
that tree (under ``_archive/variants/``) whose ``csrc/fused_step.cu`` is
changed: ``minbN`` (N a number) asks the compiler for N resident blocks of the
group kernel per SM (``__launch_bounds__(NT, N)``), which caps its registers;
``maxeN`` sizes the one-thread form's per-thread arrays (and the emits'
tables of MAX_E) for N entities (``#define MAX_E N``; time worlds of at most
N entities only: the host still packs the emits' parameters for the
package's MAX_E, which a smaller union reads only in part). The
trees run in the order given and then in reverse (A B C C B A), each in a
process of its own that imports its tree's package, builds its kernels and
reports the kernel's device time per launch (torch.profiler, 200 launches;
20 for a launch above 1 ms) for each world and form:

* transport (4 agents), balance and give_way (the in-kernel PID), 4096 envs,
  each after a reset and 5 random steps: the rows step and the fused step,
  and give_way's rows step of 4 env steps per launch;
* joint_passage (the rows step and the fused step; with its PID, the rows
  step), multi_give_way (the rows step), waterfall and wind_flocking (the
  fused step; wind_flocking's has dynamic gravity), 4096 envs, from
  ``vmas_tpu_torch.testing``'s contact states;
* simple_spread, 3 agents and discrete actions, at 4096 envs (both forms,
  and the rows step of 4 env steps) and 30000 envs (the rows step), and
  simple (both forms), from ``testing.mpe_state``;
* simple_tag, simple_world_comm, simple_push, simple_adversary,
  simple_reference and simple_speaker_listener at their defaults, 4096
  envs (both forms), from ``testing.mpe_family_state``;
* reverse_transport, wheel, passage, dispersion and dropout (both forms)
  and het_mass (the fused step) at their defaults, 4096 envs, from
  ``testing.holonomic_state``;
* buzz_wire, ball_trajectory, ball_passage and joint_passage_size (both
  forms; with its PID, the rows step) and asym_joint (the fused step, no
  emit) at their defaults, 4096 envs, from ``testing.joint_worlds_state``
  and ``testing.asym_joint_state``;
* navigation and flocking (both forms; flocking's target on the action
  rows) and discovery (the fused step) at their defaults, 4096 envs, from
  ``testing.sensor_state``;
* football's two fused configs (the red AI's: the fused step; both teams
  as policies: both forms, the ball's script in the rows step) at 4096
  envs, from ``testing.football_state``;
* the all-pairs world, 4096 envs: the fused step from its packed state.

In a tree whose kernel runs an env on a group of lanes (``fused.LANES``; 1 is
one thread per env) each form is timed at every lane count, and the count the
world's rule picks is marked; a tree whose package builds only the counts
the rule picks (``fused.LANES_BUILT``) is timed on its all-lanes build
(``_kernels.build_variant("fused_step", ["VMAS_FUSED_ALL_LANES"])``, into
the tree's ``_build/variants/``); a tree of one thread per env only (before
the lane kernel) is timed once per form, as ``thread``. Prints the card's name and
power limit, one JSON line per run, and a table of each tree's mean, minimum
and maximum per form and lane count. ``--worlds a,b`` times those worlds
only (the labels below; ``all_pairs`` too), and ``--lanes 1,8`` those lane
counts only (a tree whose package builds them all is then timed without its
all-lanes build). Needs one GPU.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B = 4096
WIDE = 30000
LAUNCHES = 200


def device_us(fn):
    """Device time per call of ``fn`` in kernels named fused_step_kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = LAUNCHES if start.elapsed_time(end) < 1.0 else LAUNCHES // 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and "fused_step_kernel" in ev.name)
    if us <= 0:
        raise AssertionError("the profiler saw no fused_step_kernel")
    return us / n


# label -> (scenario, make_env kwargs, envs, testing's state builder or None
# for a reset and 5 random steps, forms timed: rows, fused, or rows4, the
# rows step of 4 env steps per launch)
MPE = {"continuous_actions": False}
WORLDS = {
    "transport": ("transport", {"n_agents": 4}, B, None, ("rows", "fused")),
    "balance": ("balance", {}, B, None, ("rows", "fused")),
    "give_way": ("give_way", {}, B, None, ("rows", "fused", "rows4")),
    "joint_passage": ("joint_passage", {}, B, "joint_passage_contact_state", ("rows", "fused")),
    "joint_passage+pid": ("joint_passage", {"use_controller": True}, B, "joint_passage_contact_state", ("rows",)),
    "multi_give_way": ("multi_give_way", {}, B, "multi_give_way_contact_state", ("rows",)),
    "waterfall": ("waterfall", {}, B, "waterfall_contact_state", ("fused",)),
    "wind_flocking": ("wind_flocking", {}, B, "wind_flocking_state", ("fused",)),
    "simple_spread": ("simple_spread", MPE, B, "mpe_state", ("rows", "fused", "rows4")),
    f"simple_spread@{WIDE}": ("simple_spread", MPE, WIDE, "mpe_state", ("rows",)),
    "simple": ("simple", MPE, B, "mpe_state", ("rows", "fused")),
    **{name: (name, {}, B, "mpe_family_state", ("rows", "fused")) for name in (
        "simple_tag", "simple_world_comm", "simple_push", "simple_adversary", "simple_reference",
        "simple_speaker_listener")},
    **{name: (name, {}, B, "holonomic_state", ("rows", "fused")) for name in (
        "reverse_transport", "wheel", "passage", "dispersion", "dropout")},
    "het_mass": ("het_mass", {}, B, "holonomic_state", ("fused",)),
    **{name: (name, {}, B, "joint_worlds_state", ("rows", "fused")) for name in (
        "buzz_wire", "ball_trajectory", "ball_passage", "joint_passage_size")},
    "joint_passage_size+pid": ("joint_passage_size", {"use_vel_controller": True}, B, "joint_worlds_state",
                               ("rows",)),
    "asym_joint": ("asym_joint", {}, B, "asym_joint_state", ("fused",)),
    "navigation": ("navigation", {}, B, "sensor_state", ("rows", "fused")),
    "flocking": ("flocking", {}, B, "sensor_state", ("rows", "fused")),
    "discovery": ("discovery", {}, B, "sensor_state", ("fused",)),
    "football": ("football", {}, B, "football_state", ("fused",)),
    "football,two_teams": ("football", {"ai_red_agents": False}, B, "football_state", ("rows", "fused")),
}


def child(label, worlds=None, only_lanes=None):
    import numpy as np
    import torch

    import vmas_tpu_torch
    import vmas_tpu_torch.core as TC
    from vmas_tpu_torch import _kernels, make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy

    build_s = _kernels.build_all()
    if hasattr(F, "LANES_BUILT") and not set(only_lanes or F.LANES) <= set(F.LANES_BUILT):
        # the package builds only the lane counts the rule picks: time every
        # count on the all-lanes build
        t0 = time.perf_counter()
        path = _kernels.build_variant("fused_step", ["VMAS_FUSED_ALL_LANES"])
        _kernels._LIBS["fused_step"] = _kernels.library("fused_step", path)
        build_s = {"package": build_s, "all_lanes": time.perf_counter() - t0}
    dev = torch.device("cuda")
    out = {"label": label, "package": str(Path(vmas_tpu_torch.__file__).parent), "build_s": build_s,
           "us": {}, "rule": {}}
    lanes = getattr(F, "LANES", None)
    if lanes is not None and only_lanes:
        lanes = tuple(L for L in lanes if L in only_lanes)

    def timed(key, ks, fn):
        if lanes is None:
            out["us"][key] = {"thread": device_us(fn)}
            return
        rule = ks.lanes
        out["rule"][key] = rule
        try:
            res = {}
            for L in lanes:
                ks.lanes = L
                res[str(L)] = device_us(fn)
            out["us"][key] = res
        finally:
            ks.lanes = rule

    for world, (name, kw, n, build, forms) in WORLDS.items():
        if worlds and world not in worlds:
            continue
        try:
            env = make_env(name, n, device=dev, seed=0, fused_physics=True, **kw)
        except ValueError:
            continue  # not in this tree
        if build is None:
            env.reset()
            for _ in range(5):
                env.step(env.get_random_actions())
            state = env.state
        else:
            state = state_from_numpy(env.world, getattr(testing, build)(env, np.random.default_rng(3)))
        wd, fo = env.world, env._fused_outputs
        ks = F._kernel_spec(wd)
        # the policy agents, then the scripted agents whose actions ride the
        # action rows (flocking's target)
        slots = [a.index for a in env.agents] + list(getattr(fo, "script_slots", ()))
        gen = torch.Generator(device=dev).manual_seed(1)
        act = ((torch.rand((2 * len(slots), n), generator=gen, device=dev) * 2 - 1) * 0.6).contiguous()
        for k in (1, 4):
            if f"rows{'' if k == 1 else k}" not in forms:
                continue
            step = F.make_rows_step(wd, fo, slots, k_steps=k)
            carry = F.pack_carry(wd, state, fo)
            act_k = act.repeat(k, 1).contiguous()
            extra = torch.empty((k * (fo.n_out + fo.n_ctrl_out), n), device=dev)
            timed(f"rows_step[{world}{'' if k == 1 else f',k{k}'}]", ks, lambda: step(carry, act_k, extra))
        if "fused" in forms:
            parts = [F.state_rows(state), state.joint_fixed_rot.T]
            if ks.dyn_gravity:
                parts += [state.dyn_gravity[..., 0].T, state.dyn_gravity[..., 1].T]
            if fo is not None:
                parts.append(torch.as_tensor(fo.scratch_rows(state), dtype=torch.float32, device=dev))
            x = torch.cat(parts).contiguous()
            timed(f"fused_step[{world}]", ks, lambda: F.fused_step(wd, x, fo))
        del env, state
    if not worlds or "all_pairs" in worlds:
        aw = testing.all_pairs_world(TC, B, dev)
        xa = F.state_rows(state_from_numpy(aw, testing.all_pairs_state(np.random.default_rng(4), B))).contiguous()
        timed("fused_step[all_pairs]", F._kernel_spec(aw), lambda: F.fused_step(aw, xa))
    print(json.dumps(out), flush=True)


def _minblocks(src, n):
    src, k = re.subn(r"__launch_bounds__\(NT\)\nfused_step_kernel\(", f"__launch_bounds__(NT, {n})\nfused_step_kernel(",
                     src)
    if k != 1:
        raise SystemExit("no __launch_bounds__(NT) on fused_step_kernel in fused_step.cu")
    return src


def _max_entities(src, n):
    src, k = re.subn(r"#define MAX_E \d+\n", f"#define MAX_E {n}\n", src)
    if k != 1:
        raise SystemExit("no #define MAX_E in fused_step.cu")
    return src


def tree_of(spec):
    """(label, tree path) of ``label=path[:variant]``, making the variant."""
    label, _, rest = spec.partition("=")
    path, _, variant = rest.partition(":")
    tree = (ROOT / path).resolve()
    if not variant:
        return label, tree
    m = re.fullmatch(r"(minb|maxe)(\d+)", variant)
    if not m:
        raise SystemExit(f"unknown variant {variant!r}")
    dst = ROOT / "_archive" / "variants" / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / "vmas_tpu_torch", dst / "vmas_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = dst / "vmas_tpu_torch" / "csrc" / "fused_step.cu"
    edit = _minblocks if m.group(1) == "minb" else _max_entities
    cu.write_text(edit(cu.read_text(), int(m.group(2))))
    return label, dst


def _option(args, name):
    """The comma-separated values of ``--name v1,v2`` in ``args`` (removed
    from them), or None."""
    if name not in args:
        return None
    i = args.index(name)
    values = args[i + 1].split(",")
    del args[i:i + 2]
    return values


def main():
    args = sys.argv[1:]
    worlds = _option(args, "--worlds")
    lanes = _option(args, "--lanes")
    only_lanes = [int(v) for v in lanes] if lanes else None
    if "--child" in args:
        return child(args[args.index("--child") + 1], worlds, only_lanes)
    import torch

    if not torch.cuda.is_available():
        print("time_fused_step: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = [tree_of(a) for a in args]
    extra = (["--worlds", ",".join(worlds)] if worlds else []) + (["--lanes", ",".join(lanes)] if lanes else [])
    runs = []
    for label, tree in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=str(tree))
        res = subprocess.run([sys.executable, __file__, "--child", label, *extra], cwd=tree, env=env,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise SystemExit(f"{label}: the run failed")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        if not line["package"].startswith(str(tree)):
            raise SystemExit(f"{label}: imported {line['package']}, not the tree's package")
        print(json.dumps(line), flush=True)
        runs.append(line)
    forms = list(dict.fromkeys(f for r in runs for f in r["us"]))
    print(f"device us per launch, mean [min, max] of each tree's runs; * the lane count the rule picks ({card}):")
    for form in forms:
        print(form)
        for label, _ in trees:
            mine = [r for r in runs if r["label"] == label and form in r["us"]]
            if not mine:
                continue
            rule = mine[0]["rule"].get(form)
            cells = []
            for key in mine[0]["us"][form]:
                v = [r["us"][form][key] for r in mine]
                mark = "*" if key == str(rule) else ""
                cells.append(f"{key}{mark} {sum(v) / len(v):.3f} [{min(v):.3f}, {max(v):.3f}]")
            print(f"  {label.ljust(12)} " + "; ".join(cells))


if __name__ == "__main__":
    main()
