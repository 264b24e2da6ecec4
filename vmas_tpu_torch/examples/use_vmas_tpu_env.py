"""Throughput and usage example; counterpart of the repo's
examples/use_vmas_tpu_env.py.

Steps a scenario with random actions and prints wall-clock numbers for both
the per-call API (``env.step``) and a rollout of the same steps
(``parallel.rollout_fn``).

  python -m vmas_tpu_torch.examples.use_vmas_tpu_env --scenario transport --num_envs 4096
"""

import argparse
import time

import torch

from vmas_tpu_torch.examples import sync


def main(scenario="transport", num_envs=4096, n_steps=200, render=False, device=None, **kwargs):
    """Returns ``{"per_call": env-steps/s, "rollout": env-steps/s}``."""
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.parallel.rollout import rollout_fn

    env = make_env(scenario, num_envs=num_envs, seed=0, device=device, **kwargs)

    # per-call API
    acts = env.get_random_actions()
    env.step(acts)  # warm-up: kernel loads, allocator
    sync(env.device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        obs, rews, dones, infos = env.step(acts)
        if render:
            env.render(mode="rgb_array")
    sync(env.device)
    dt = time.perf_counter() - t0
    rates = {"per_call": n_steps * num_envs / dt}
    print(f"[per-call] {scenario}: {n_steps} steps x {num_envs} envs in {dt:.2f}s "
          f"-> {rates['per_call']:,.0f} env-steps/s")

    # a rollout of the same steps, random actions drawn for the horizon
    run = rollout_fn(env, horizon=n_steps)
    state, steps, traj = run(env.state, env.steps, torch.Generator(device=env.device).manual_seed(0))
    sync(env.device)
    t0 = time.perf_counter()
    state, steps, traj = run(state, steps, torch.Generator(device=env.device).manual_seed(1))
    sync(env.device)
    dt = time.perf_counter() - t0
    rates["rollout"] = n_steps * num_envs / dt
    print(f"[rollout] {scenario}: {n_steps} steps x {num_envs} envs in {dt:.2f}s "
          f"-> {rates['rollout']:,.0f} env-steps/s")
    return rates


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default="transport")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--n_steps", type=int, default=200)
    p.add_argument("--render", action="store_true")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
