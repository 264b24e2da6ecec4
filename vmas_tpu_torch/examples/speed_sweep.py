"""The VMAS speed protocol swept over env counts; counterpart of the repo's
examples/speed_sweep.py.

The original study (``mpe_comparison/mpe_performance_comparison.py``,
run_vmas_simple_spread): ``simple_spread``, 3 agents, discrete actions
(every agent holds action 2), 100 steps, wall-clock seconds over
``num_envs``. Timed per point, on the plain physics and on the fused
kernel:

* ``loop``: ``env.step()`` from Python, 100 times, like the original's loop;
* ``rollout``: ``rollout_fn`` over the same 100 steps;
* ``rows`` (fused only, where the env is rows-eligible):
  ``rows_policy_rollout_fn``, one launch of the rows kernel a step.

Each is timed after one untimed warm-up, from the same reset state, with a
device sync at its end.

  python -m vmas_tpu_torch.examples.speed_sweep --n_envs 32 4096 30000
"""

import argparse
import time

import torch

from vmas_tpu_torch.examples import sync

N_AGENTS = 3
N_STEPS = 100


def _timed(env, fn):
    """Seconds of ``fn()`` from the env's reset state, after one warm-up."""
    for _ in range(2):
        env.reset(seed=0)
        sync(env.device)
        t0 = time.perf_counter()
        fn()
        sync(env.device)
    return time.perf_counter() - t0


def run_point(n_envs: int, fused: bool = False, device=None, n_steps: int = N_STEPS):
    """``(loop s, rollout s, rows s or None)`` at ``n_envs``."""
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.parallel import rollout_fn, rows_policy_rollout_fn, rows_rollout_supported

    env = make_env("simple_spread", num_envs=n_envs, seed=0, continuous_actions=False, n_agents=N_AGENTS,
                   fused_physics=fused, device=device)
    actions = [torch.full((n_envs, 1), 2, dtype=torch.int64, device=env.device) for _ in range(N_AGENTS)]
    hold = lambda obs, generator: actions

    def loop():
        for _ in range(n_steps):
            env.step(actions)

    gen = torch.Generator(device=env.device)
    t_loop = _timed(env, loop)
    run = rollout_fn(env, hold, n_steps)
    t_rollout = _timed(env, lambda: run(env.state, env.steps, gen))
    t_rows = None
    if rows_rollout_supported(env):
        rows = rows_policy_rollout_fn(env, hold, n_steps)
        t_rows = _timed(env, lambda: rows(env.state, env.steps, gen))
    return t_loop, t_rollout, t_rows


def main(n_envs=(1, 32, 256, 1024, 4096, 16384, 30000), device=None, n_steps=N_STEPS):
    """Prints the table and returns its rows as dicts (``n_steps`` below the
    protocol's 100 only to smoke-test)."""
    name = torch.cuda.get_device_name() if torch.device(device or "cuda").type == "cuda" else "cpu"
    print(f"simple_spread, {N_AGENTS} agents, {n_steps} steps on {name}")
    print(f"{'n_envs':>8} {'loop s':>9} {'rollout s':>10} {'fused loop s':>13} {'fused rollout s':>16} "
          f"{'rows s':>9} {'rows env-steps/s':>17}")
    out = []
    for n in n_envs:
        t_loop, t_rollout, _ = run_point(n, device=device, n_steps=n_steps)
        f_loop, f_rollout, t_rows = run_point(n, fused=True, device=device, n_steps=n_steps)
        out.append({"n_envs": n, "loop_s": t_loop, "rollout_s": t_rollout, "fused_loop_s": f_loop,
                    "fused_rollout_s": f_rollout, "rows_s": t_rows})
        # t_rows is None where the fused config is not rows-eligible: blank columns
        rows_t = "-" if t_rows is None else f"{t_rows:.3f}"
        rows_r = "-" if t_rows is None else f"{n * n_steps / t_rows:,.0f}"
        print(f"{n:>8} {t_loop:>9.3f} {t_rollout:>10.3f} {f_loop:>13.3f} {f_rollout:>16.3f} {rows_t:>9} "
              f"{rows_r:>17}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n_envs", type=int, nargs="+", default=[1, 32, 256, 1024, 4096, 16384, 30000])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--n_steps", type=int, default=N_STEPS)
    a = p.parse_args()
    main(tuple(a.n_envs), a.device, a.n_steps)
