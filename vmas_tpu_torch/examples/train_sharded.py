"""Sharded differentiable-rollout training; counterpart of the repo's
examples/train_sharded.py.

Each rank steps its shard of the envs (``parallel.distribute``) and the
learner (``parallel.learner``) takes analytic policy gradients through the
physics; the gradients are averaged over the ranks in one all-reduce.
``--processes N`` starts N ranks on this machine, joined by gloo (the
stand-in for a multi-host launch, where each host runs this script with its
own ``--rank`` and a shared ``--init_method``).

  python -m vmas_tpu_torch.examples.train_sharded --scenario transport --num_envs 512
  python -m vmas_tpu_torch.examples.train_sharded --processes 2 --device cpu
"""

import argparse
import time

import torch

from vmas_tpu_torch.examples import RankGroup, add_rank_args, launch


def main(scenario="transport", num_envs=512, iters=20, horizon=5, lr=1e-3, processes=0, device=None,
         rank=None, world_size=None, init_method=None, backend="gloo"):
    """Train and return the MLP's parameters (``processes=N``: run N ranks
    and return None)."""
    if processes:
        return launch("vmas_tpu_torch.examples.train_sharded", processes, dict(
            scenario=scenario, num_envs=num_envs, iters=iters, horizon=horizon, lr=lr, device=device))
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.parallel import distribute
    from vmas_tpu_torch.parallel.learner import init_mlp, make_train_step

    with RankGroup(rank, world_size, init_method, backend):
        env = make_env(scenario, num_envs=num_envs, seed=0, grad_enabled=True, device=device)
        distribute(env)
        n = env.mesh.size()
        print(f"mesh: {n} ranks, {num_envs} envs ({env.num_envs}/rank) on {env.device}")
        obs_dim = int(env._observations(env.state)[0].shape[-1])
        act_dim = env.get_agent_action_size(env.agents[0])
        params = init_mlp([obs_dim, 64, 64, act_dim], generator=torch.Generator(device=env.device).manual_seed(0),
                          device=env.device)
        train = make_train_step(env, horizon=horizon, lr=lr)
        state, steps = env.state, env.steps
        gen = torch.Generator(device=env.device).manual_seed(1)
        t0 = time.perf_counter()
        for i in range(iters):
            params, state, steps, loss = train(params, state, steps, gen)
            if i % 5 == 0 or i == iters - 1:
                print(f"iter {i:3d}  loss {float(loss):+.4f}  ({time.perf_counter() - t0:.1f}s)")
        env_steps = iters * horizon * num_envs
        dt = time.perf_counter() - t0  # the float(loss) above waited for the device
        print(f"trained through {env_steps:,} env-steps in {dt:.1f}s "
              f"({env_steps / dt:,.0f} env-steps/s incl. backprop)")
    return params


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default="transport")
    p.add_argument("--num_envs", type=int, default=512)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--horizon", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--processes", type=int, default=0, help="run N gloo ranks on this machine")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    add_rank_args(p)
    main(**vars(p.parse_args()))
