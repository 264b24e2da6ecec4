"""Runner of random-action rollouts: the program's ``rows_rollout_fn`` with
uniform random actions, calls back to back, each continuing from the state
the last one returned (bench.py's protocol).

Traffic parameters: ``metric`` (the name of the end-to-end rate it
reports), ``horizon`` (env steps a call, one kernel launch a step),
``warm_calls`` (calls of set-up), ``trace_calls`` (calls of each of the
traced run's two stretches).

The check compares two calls with the plain reference: the first, from the
benchmark's own initial state, and one drawn from the seed among the
window's calls, from the state the program handed to it. Each compares the
trajectory's observations, rewards and dones and the state the call returns.
"""

from __future__ import annotations

import random
import sys
import time
from types import SimpleNamespace

from portbench import counts as C
from portbench import harness as H


def _reference_call(cell, spec, in_state, run_seed, index):
    """The reference's trajectory and final rows of call ``index`` from the
    program state ``in_state`` (the benchmark's own initial state for call
    0): the generator seeded as the program's was, advanced past the draws
    of the calls before."""
    import torch

    from portbench.reference.rollout import fork, random_rollout

    cfg = cell.reference
    gen = torch.Generator(device=in_state["pos"].device).manual_seed(run_seed)
    for _ in range(index):
        fork(gen, 2)
    carry = cfg.state_rows(in_state, cfg.scratch_rows(in_state))
    carry, extras = random_rollout(cfg, spec, carry, gen, cell.traffic["horizon"])
    return carry.to(torch.float32), cfg.unpack(extras.to(torch.float32))


def _leaves(state):
    return {"pos": state.pos, "vel": state.vel, "rot": state.rot, "ang_vel": state.ang_vel, "force": state.force,
            "torque": state.torque, "joint_fixed_rot": state.joint_fixed_rot, "scenario": state.scenario}


def carry_state(carry, E):
    """The state leaves a rows carry [9E + ..., B] holds: pos, vel, rot and
    ang_vel of the E entities, as a program state holds them."""
    import torch

    xy = lambda c: torch.stack([carry[c * E:(c + 1) * E].T, carry[(c + 1) * E:(c + 2) * E].T], -1)
    return SimpleNamespace(pos=xy(0), vel=xy(2), rot=carry[4 * E:5 * E].T, ang_vel=carry[5 * E:6 * E].T)


def compare(got_traj, got_state, want_state, want_out):
    """The compared numbers of one call: the largest absolute gap of an
    observation, a reward and a state leaf the rows carry (pos, vel, rot,
    ang_vel), and the count of env steps whose done differs."""
    import torch

    obs, rews, dones = want_out
    gap = lambda a, b: float((a - b).abs().max())
    return {
        "obs_gap": max(gap(o, w) for o, w in zip(got_traj["obs"], obs)),
        "rew_gap": gap(got_traj["rewards"], torch.stack(rews, -1)),
        "done_flips": float((got_traj["dones"] != dones).sum()),
        "state_gap": max(gap(getattr(got_state, k), getattr(want_state, k)) for k in ("pos", "vel", "rot", "ang_vel")),
    }


def check(cell, calls, run_seed):
    """Compare each ``(index, input state, trajectory, output state)`` of
    ``calls`` with the reference -> the largest reading of each number over
    them."""
    from portbench.reference.physics import Spec

    spec, E = Spec(cell.reference.WORLD), len(cell.reference.ENTITY_NAMES)
    worst = {}
    for index, in_state, traj, out_state in calls:
        want_carry, want_out = _reference_call(cell, spec, _leaves(in_state), run_seed, index)
        for k, v in compare(traj, out_state, carry_state(want_carry, E), want_out).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def run(cell, seed, seconds, trace, device, t_start):
    import torch

    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.parallel.rollout import rows_rollout_fn

    cfg, B, T = cell.reference, cell.num_envs, cell.traffic["horizon"]
    s_init, s_run = H.seeds(seed)
    t_env = time.perf_counter()
    env, make_env_s = H.make_program_env(cell, device)
    init = cfg.initial_state(B, torch.Generator(device=device).manual_seed(s_init), device)
    run_fn = rows_rollout_fn(env, horizon=T)
    gen = torch.Generator(device=device).manual_seed(s_run)
    # the running state, and only the calls the check compares: call 0 and
    # the last, and the drawn one once it has run (a state the program
    # returns holds views into its call's output buffer)
    cur = {"i": 0, "state": H.program_state(env, init), "steps": env.steps}
    kept = {}
    pick = None

    def call():
        i, in_state = cur["i"], cur["state"]
        out_state, cur["steps"], traj = run_fn(in_state, cur["steps"], gen)
        record = (i, in_state, traj, out_state)
        kept["last"] = record
        if i in (0, pick):
            kept[i] = record
        cur["i"], cur["state"] = i + 1, out_state

    # set-up: the first calls build every shape (call 0 is checked)
    for _ in range(cell.traffic["warm_calls"]):
        call()
    H.sync(device)
    t0 = time.perf_counter()
    call()
    H.sync(device)
    call_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: start to make_env {t_env - t_start:.3f}, make_env {make_env_s:.3f}, "
          f"the rest (inputs, {cur['i']} calls) {time.perf_counter() - t_env - make_env_s:.3f}",
          file=sys.stderr, flush=True)
    first = cur["i"]
    rng = random.Random(seed)
    readings, e2e, breakdown = {"kind": "rollout", "make_env_s": make_env_s}, {}, None

    if not trace:
        pick = first + rng.randrange(max(1, int(0.9 * seconds / call_s)))
        n, window_s = H.window(call, seconds, device)
        e2e = {cell.traffic["metric"]: B * T * n / window_s, "setup_s": setup_s}
        print(f"window: {n} calls of {T} steps x {B} envs in {window_s:.6f} s", file=sys.stderr, flush=True)
    else:
        n_tr = cell.traffic["trace_calls"]
        pick = first + rng.randrange(2 * n_tr)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(n_tr):
            call()
        ev1.record()
        ev1.synchronize()
        stretch_s = ev0.elapsed_time(ev1) / 1e3
        bound_s, by, ops, nbytes = C.k2_bound(cfg, F.pack_carry(env.world, cur["state"], env._fused_outputs), B)
        launches0 = F.rows_step_launches

        def traced():
            for _ in range(n_tr):
                call()

        dev, host, wall = H.profile(traced, device)
        k2_n, k2_s = H.kernel_time(dev, "fused_step_kernel")
        summary = H.trace_summary(dev, host, wall)
        breakdown = summary.pop("breakdown")
        steps_tr = n_tr * T
        readings.update(summary, steps=steps_tr, stretch_s=stretch_s, k2_launches=k2_n, k2_s=k2_s,
                        k2_bound_s=bound_s)
        print(f"traced stretch: {n_tr} calls, {steps_tr} steps, {summary['device_ops']} device operations, "
              f"K2 {k2_n} launches (fused.rows_step_launches counted {F.rows_step_launches - launches0}), "
              f"{k2_s / max(k2_n, 1) * 1e6:.3f} us a launch on the device against a bound of {bound_s * 1e6:.3f} us "
              f"({by}: {ops} operations, {nbytes} bytes); untraced stretch {stretch_s:.6f} s, traced {wall:.6f} s",
              file=sys.stderr, flush=True)
        n = 2 * n_tr

    peak = torch.cuda.max_memory_allocated() if str(device).startswith("cuda") else 0
    calls = [kept[0], kept.get(pick, kept["last"])]
    kept.clear()
    del env, run_fn, cur
    t0 = time.perf_counter()
    worst = check(cell, calls, s_run)
    checks, ok = H.checks_of(worst, cell.limits)
    print(f"check of calls {[c[0] for c in calls]}: {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    return {"correct": ok, "attempted": n, "failed": 0 if ok else 1, "e2e": e2e, "readings": readings,
            "breakdown": breakdown, "checks": checks, "memory_peak_bytes": peak}


def control(cell, seed, device):
    """The compared numbers of the lower-precision control: the reference
    in bfloat16 put in the program's place for the first call from the
    seed's initial state, against the reference in float32."""
    import torch

    from portbench.reference.physics import Spec

    cfg, E = cell.reference, len(cell.reference.ENTITY_NAMES)
    s_init, s_run = H.seeds(seed)
    init = cfg.initial_state(cell.num_envs, torch.Generator(device=device).manual_seed(s_init), device)
    want_carry, want_out = _reference_call(cell, Spec(cfg.WORLD), init, s_run, 0)
    low_carry, (obs, rews, dones) = _reference_call(cell, Spec(cfg.WORLD, torch.bfloat16), init, s_run, 0)
    got_traj = {"obs": obs, "rewards": torch.stack(rews, -1), "dones": dones}
    return compare(got_traj, carry_state(low_carry, E), carry_state(want_carry, E), want_out)
