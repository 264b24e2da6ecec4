#!/usr/bin/env python3
"""Smoke run of vmas_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

1. Checks for a GPU and prints its name and power limit (nvidia-smi).
2. Builds the CUDA kernels from vmas_tpu_torch/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version at full width
   (transport, 4096 envs, 4 agents): 20 steps of the rows step and of the
   fused step from one state, re-synced to the kernel's output each step;
   then the env.step rollout against the rows rollout over a short horizon.
4. Drives the main path with the launch counts zeroed: make_env on the
   GPU, reset, 5 env.step calls, then rows_rollout_fn(horizon=1000) once
   to warm up and 3 timed calls; checks the shapes, finiteness and launch
   counts, and prints env-steps/s.
5. Prints one JSON line describing each kernel, then the result line.

Any failure raises and exits non-zero. It imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

NUM_ENVS = 4096
N_AGENTS = 4
HORIZON = 1000
TIMED_CALLS = 3
CMP_STEPS = 20
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# tolerances, kernel against plain: state rows (f32 reorder noise),
# observation rows, reward and shaping rows (x100 shaping factor)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
OBS_ATOL = 2e-5
REW_ATOL = 2e-3
OG_MARGIN = 1e-5


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, n):
    """Mean ms per call of ``fn`` over ``n`` back-to-back calls (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n, kernel):
    """Device time per call over ``n`` calls of ``fn``, from torch.profiler:
    ``(ms of kernels whose name holds `kernel`, ms of all device work,
    {kernel name: ms})``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / n
    mine = sum(v for k, v in by_name.items() if kernel in k)
    return mine, sum(by_name.values()), by_name


def flops_per_env(ks, fo):
    """Estimated f32 operations of one env step (a transcendental counted
    as 20): per entity and substep ~20, per sphere-sphere pair ~70, per
    box-sphere pair ~200, transport's emit ~200 per package plus the
    observation rows."""
    per_substep = 20 * ks.E + 70 * len(ks.ss) + 200 * len(ks.bs)
    return ks.substeps * per_substep + 200 * fo.n_pkgs + fo.n_out


class ErrTracker:
    def __init__(self):
        self.err = {}

    def close(self, name, got, want, atol, rtol=0.0):
        import torch

        diff = (got - want).abs()
        self.err[name] = max(self.err.get(name, 0.0), float(diff.max()))
        ok = diff <= atol + rtol * want.abs()
        if not bool(ok.all()):
            raise AssertionError(f"{name}: {int((~ok).sum())} values beyond atol={atol} rtol={rtol}, "
                                 f"max abs err {float(diff.max()):.3e}")
        return float(diff.max())

    def max(self):
        return max(self.err.values())


def og_margin(fo, state_rows, E):
    """Per env, the smallest distance of transport's on_goal test to its
    threshold (dist vs d_closest_box, d_sphere_closest vs og_dmin)."""
    import torch
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.core.utils import LINE_MIN_DIST

    px, py, rot = state_rows[:E], state_rows[E:2 * E], state_rows[4 * E:5 * E]
    gx, gy = px[fo.goal_i], py[fo.goal_i]
    margins = []
    for k, pi in enumerate(fo.pkg_i):
        dist = F._norm(px[pi] - gx, py[pi] - gy)
        cx, cy = F._closest_point_box(px[pi], py[pi], torch.cos(rot[pi]), torch.sin(rot[pi]),
                                      fo.pkg_hw[k], fo.pkg_hl[k], gx, gy)
        d1 = (dist - F._norm(px[pi] - cx, py[pi] - cy)).abs()
        d2 = (F._norm(gx - cx, gy - cy) - (fo.radius + LINE_MIN_DIST)).abs()
        margins.append(torch.minimum(d1, d2))
    return torch.stack(margins).min(0).values


def compare_rows(tr, fo, E, state_k, state_p, emit_k, emit_p, tag):
    """Kernel against plain for one step's state and emit rows; returns the
    number of on_goal lanes excused for lying within OG_MARGIN of the
    threshold."""
    A, w = fo.n_agents, fo.obs_w
    tr.close(f"{tag} state rows", state_k, state_p, **STATE_TOL)
    tr.close(f"{tag} obs rows", emit_k[:A * w], emit_p[:A * w], OBS_ATOL, 1e-5)
    r = A * w
    og_k, og_p = emit_k[r + 1:r + 1 + fo.n_pkgs], emit_p[r + 1:r + 1 + fo.n_pkgs]
    differ = (og_k != og_p).any(0)
    near = og_margin(fo, state_p, E) < OG_MARGIN
    if bool((differ & ~near).any()):
        raise AssertionError(f"{tag}: on_goal differs in {int((differ & ~near).sum())} lanes off the threshold")
    ok = ~differ
    tr.close(f"{tag} reward row", emit_k[r][ok], emit_p[r][ok], REW_ATOL)
    tr.close(f"{tag} shaping rows", emit_k[r + 1 + fo.n_pkgs:], emit_p[r + 1 + fo.n_pkgs:], REW_ATOL, 1e-5)
    return int((differ & near).sum())


def contact_rich(env, gen):
    """The env's state with every env in contact: agents 0 and 1 side by
    side against the package's -x face, the other agents around it at
    contact range, the goal near the package; random rotations, velocities
    and forces. Random actions alone seldom bring an agent to the package
    within a few steps."""
    import torch

    st, sc, dev = env.state, env.scenario, env.device
    B, E = st.pos.shape[:2]
    rnd = lambda *s: torch.rand(s, generator=gen, device=dev)
    nrm = lambda *s: torch.randn(s, generator=gen, device=dev)
    pi, gi = sc.packages[0].index, sc.goal.index
    ai = [a.index for a in env.world.agents]
    pos = torch.zeros((B, E, 2), device=dev)
    pkg = (rnd(B, 2) * 2 - 1) * 0.8
    pos[:, pi] = pkg
    pos[:, gi] = pkg + nrm(B, 2) * 0.15
    pos[:, ai[0]] = pkg + torch.tensor([-0.1, 0.024], device=dev) + nrm(B, 2) * 0.004
    pos[:, ai[1]] = pkg + torch.tensor([-0.1, -0.024], device=dev) + nrm(B, 2) * 0.004
    for a in ai[2:]:
        ang = rnd(B) * 6.283185307179586
        r = 0.1 + nrm(B) * 0.01
        pos[:, a] = pkg + torch.stack([ang.cos(), ang.sin()], -1) * r[:, None]
    return st.replace(
        pos=pos, vel=nrm(B, E, 2) * 0.3, rot=(rnd(B, E) * 2 - 1) * 3.14159,
        ang_vel=nrm(B, E) * 0.2, force=nrm(B, E, 2) * 0.5,
    )


def contacts(ks, rows):
    """(sphere-sphere pair contacts, box-sphere pair contacts) over the envs
    of one step's input rows, from the penalty forces' plain version."""
    import torch
    from vmas_tpu_torch.core import fused as F

    E = ks.E
    px, py, rot = rows[:E], rows[E:2 * E], rows[4 * E:5 * E]
    n_ss = sum(int((F._constraint_force(ks.cm, px[a], py[a], px[b], py[b], d, ks.cf)[0] != 0).sum())
               for a, b, d in ks.ss)
    n_bs = 0
    for b, s, hw, hl, d0, nh in ks.bs:
        cx, cy = F._closest_point_box(px[b], py[b], torch.cos(rot[b]), torch.sin(rot[b]), hw, hl, px[s], py[s])
        ix, iy, d = F._inner_point_box(px[s], py[s], cx, cy, px[b], py[b])
        n_bs += int((F._constraint_force(ks.cm, px[s], py[s], ix, iy, d0 + d, ks.cf)[0] != 0).sum())
    return n_ss, n_bs


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        sys.exit(1)
    from vmas_tpu_torch import _kernels, make_env
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn

    card = card_line()
    print(card, flush=True)

    # -- 2. build -----------------------------------------------------------
    print(f"build: {_kernels.build_all():.1f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)})", flush=True)

    # -- 3. kernel against plain, at full width ------------------------------
    dev = torch.device("cuda")
    env = make_env("transport", NUM_ENVS, device=dev, n_agents=N_AGENTS, seed=0, fused_physics=True)
    world, fo = env.world, env._fused_outputs
    slots = [a.index for a in env.agents]
    ks = F._kernel_spec(world)
    E, A, B = ks.E, len(slots), NUM_ENVS
    R_in = F.rows_layout(world, fo)
    gen = torch.Generator(device=dev).manual_seed(1)
    step = F.make_rows_step(world, fo, slots)

    def acts():
        return ((torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1) * 0.6).contiguous()

    k2, k1 = ErrTracker(), ErrTracker()
    excused = {"rows_step": 0, "fused_step": 0}
    n_ss = n_bs = 0
    carry = F.pack_carry(world, contact_rich(env, gen), fo)
    for t in range(CMP_STEPS):
        act = acts()
        c_k, e_k = step(carry, act)
        c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
        excused["rows_step"] += compare_rows(k2, fo, E, c_k[:9 * E], c_p[:9 * E], e_k, e_p, "rows_step")
        k2.close("rows_step scratch carry", c_k[9 * E:], c_p[9 * E:], REW_ATOL, 1e-5)
        s, b_ = contacts(ks, c_p)
        n_ss, n_bs = n_ss + s, n_bs + b_
        carry = c_k  # re-sync to the kernel

        # the fused step on the same state, as env.step packs it
        x = carry.clone()
        x[6 * E + torch.as_tensor(slots, device=dev)] = act[:A]
        x[7 * E + torch.as_tensor(slots, device=dev)] = act[A:]
        y_k = F.fused_step(world, x, fo)
        y_p = F.fused_step_plain(world, x, fo)
        excused["fused_step"] += compare_rows(k1, fo, E, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:],
                                              "fused_step")
    torch.cuda.synchronize()
    for tr in (k2, k1):
        for name, v in tr.err.items():
            print(f"max abs err {name}: {v:.3e}")
    print(f"contacts over {CMP_STEPS} steps: {n_ss} sphere-sphere, {n_bs} box-sphere; "
          f"on_goal lanes within {OG_MARGIN} of the threshold: {excused}", flush=True)
    if n_ss == 0 or n_bs == 0:
        raise AssertionError("the comparison saw no contacts of one type")

    # env.step's path (the fused kernel) against the rows path (the rows
    # kernel): one device function, so the same trajectory
    s0, st0 = env.state, env.steps
    g1 = torch.Generator(device=dev).manual_seed(7)
    g2 = torch.Generator(device=dev).manual_seed(7)
    _, _, ta = rollout_fn(env, horizon=CMP_STEPS)(s0, st0, g1)
    _, _, tb = rows_rollout_fn(env, horizon=CMP_STEPS)(s0, st0, g2)
    same = torch.equal(ta["rewards"], tb["rewards"]) and all(torch.equal(a, b) for a, b in zip(ta["obs"], tb["obs"]))
    rollout_err = max(float((a - b).abs().max()) for a, b in zip(ta["obs"], tb["obs"]))
    print(f"env.step rollout vs rows rollout over {CMP_STEPS} steps: bitwise equal {same}, "
          f"max abs obs err {rollout_err:.3e}", flush=True)
    if rollout_err > OBS_ATOL:
        raise AssertionError("env.step rollout and rows rollout disagree")

    # per-launch times of each kernel and its plain version: the kernel's
    # own device time (profiler), and the wall time per back-to-back call
    # (CUDA events), which includes the host's launch path
    act = acts()
    x = carry.clone()
    extra = torch.empty((fo.n_out, B), device=dev)
    times = {
        "rows_step": (lambda: step(carry, act, extra), lambda: F.rows_step_plain(world, fo, slots, carry, act)),
        "fused_step": (lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo)),
    }
    for name, (kern, plain) in list(times.items()):
        dev_ms = device_ms(kern, 200, "fused_step_kernel")[0]
        if dev_ms <= 0:
            raise AssertionError(f"the profiler saw no device time for {name}")
        times[name] = {"ms": dev_ms, "wall_ms": time_ms(kern, 500), "plain_ms": time_ms(plain, 20)}
        print(f"{name}: kernel {dev_ms * 1e3:.3f} us on the device, {times[name]['wall_ms'] * 1e3:.3f} us per "
              f"back-to-back call, plain version {times[name]['plain_ms'] * 1e3:.1f} us per call", flush=True)

    # -- 4. the main path ----------------------------------------------------
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    env = make_env("transport", num_envs=NUM_ENVS, n_agents=N_AGENTS, seed=0, fused_physics=True)
    assert env.device.type == "cuda"
    obs = env.reset()
    for _ in range(5):
        obs, rews, dones, infos = env.step(env.get_random_actions())
    assert all(o.shape == (NUM_ENVS, 4 + 7) and bool(torch.isfinite(o).all()) for o in obs)
    assert all(r.shape == (NUM_ENVS,) and bool(torch.isfinite(r).all()) for r in rews)
    assert dones.shape == (NUM_ENVS,)

    run = rows_rollout_fn(env, horizon=HORIZON)
    rgen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    state, steps, traj = run(env.state, env.steps, rgen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    call_ms = []
    for _ in range(TIMED_CALLS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, steps, traj = run(state, steps, rgen)
        end.record()
        end.synchronize()
        call_ms.append(start.elapsed_time(end))
    launches = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}

    assert traj["rewards"].shape == (HORIZON, NUM_ENVS, N_AGENTS)
    assert traj["dones"].shape == (HORIZON, NUM_ENVS)
    assert len(traj["obs"]) == N_AGENTS and all(o.shape == (HORIZON, NUM_ENVS, 11) for o in traj["obs"])
    assert bool(torch.isfinite(traj["rewards"]).all()) and all(bool(torch.isfinite(o).all()) for o in traj["obs"])
    assert bool(torch.isfinite(state.pos).all())
    assert int(steps[0]) == 5 + HORIZON * (1 + TIMED_CALLS)
    assert launches["fused_step"] == 5, launches
    assert launches["rows_step"] == HORIZON * (1 + TIMED_CALLS), launches
    rate = NUM_ENVS * HORIZON / (min(call_ms) / 1e3)
    print(f"main path: rows_rollout_fn transport {NUM_ENVS} envs x {N_AGENTS} agents x {HORIZON} steps: "
          f"calls {[round(c, 3) for c in call_ms]} ms (warm-up {warm_s:.3f} s), "
          f"best {rate:.1f} env-steps/s, mean {NUM_ENVS * HORIZON * TIMED_CALLS / (sum(call_ms) / 1e3):.1f} "
          f"env-steps/s on {card}; launches {launches}", flush=True)

    # where one main-path call's device time goes (read after the counts:
    # these launches are not the main path's)
    _, busy_ms, by_name = device_ms(lambda: run(state, steps, rgen), 1, "fused_step_kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"device time of one rows_rollout_fn call: {busy_ms:.3f} ms busy of {min(call_ms):.3f} ms wall "
          f"(idle share {1 - busy_ms / min(call_ms):.3f}); top: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top), flush=True)

    # -- 5. the kernels line -------------------------------------------------
    flops = flops_per_env(ks, fo) * B
    rows_bytes = (R_in + 2 * A + R_in + fo.n_out) * B * 4
    fused_bytes = (R_in + 9 * E + fo.n_out) * B * 4

    def entry(name, replaces, err, nbytes):
        t = times[name]
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
        bound = max(t_bytes, t_ops)
        return {
            "name": name, "route": "cuda", "source": "vmas_tpu_torch/csrc/fused_step.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
            "wall_ms": t["wall_ms"], "us": t["ms"] * 1e3, "plain_us": t["plain_ms"] * 1e3,
            "bound_us": bound * 1e3, "bytes": nbytes, "flops_est": flops,
        }

    kernels = [
        entry("rows_step", "vmas_tpu/core/fused.py:1603", k2.max(), rows_bytes),
        entry("fused_step", "vmas_tpu/core/fused.py:1425", k1.max(), fused_bytes),
    ]
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
