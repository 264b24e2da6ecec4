"""Run a scenario's HeuristicPolicy; counterpart of the repo's
examples/run_heuristic.py.

Scenarios with heuristics: transport, balance, wheel, flocking, navigation,
discovery.

  python -m vmas_tpu_torch.examples.run_heuristic --scenario transport --num_envs 32
"""

import argparse
import importlib
import time

import torch


def main(scenario_name="transport", num_envs=32, n_steps=200, render=False, save_render=False, device=None,
         **kwargs):
    """Returns the mean reward a step."""
    from vmas_tpu_torch import make_env

    module = importlib.import_module(f"vmas_tpu_torch.scenarios.{scenario_name}")
    policy = module.HeuristicPolicy(continuous_action=True)

    env = make_env(scenario_name, num_envs=num_envs, seed=0, device=device, **kwargs)
    obs = env.reset(seed=0)

    frames = []
    total_reward = 0.0
    t0 = time.perf_counter()
    for _ in range(n_steps):
        actions = [policy.compute_action(o, u_range=float(a.u_range_array[0])) for o, a in zip(obs, env.agents)]
        obs, rews, dones, info = env.step(actions)
        total_reward += float(torch.stack(rews).mean())
        if render:
            frames.append(env.render(mode="rgb_array", env_index=0))
    dt = time.perf_counter() - t0

    print(f"{scenario_name}: {n_steps} steps x {num_envs} envs in {dt:.2f}s, "
          f"mean reward/step {total_reward / n_steps:.3f}")
    if render and save_render:
        from vmas_tpu_torch.render.video import save_video

        save_video(scenario_name, frames, fps=1 / 0.1)
    return total_reward / n_steps


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", dest="scenario_name", default="transport")
    p.add_argument("--num_envs", type=int, default=32)
    p.add_argument("--n_steps", type=int, default=200)
    p.add_argument("--render", action="store_true")
    p.add_argument("--save_render", action="store_true")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
