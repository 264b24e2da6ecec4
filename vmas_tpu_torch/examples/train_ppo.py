"""End-to-end PPO training on a scenario (multi-agent, one shared policy);
counterpart of the repo's examples/train_ppo.py.

The PPO machinery lives in ``vmas_tpu_torch.parallel.ppo`` (this file is the
CLI). ``--collect rows`` collects through the rows policy rollout (one
launch of the fused rows kernel a step; needs ``--fused_physics``);
``--collect step`` through the env's own step with autoresets.
``--processes N`` trains on N ranks of this machine joined by gloo, each
collecting on its shard of the envs (``parallel.distribute``) and taking
the global batch's step.

  python -m vmas_tpu_torch.examples.train_ppo --num_envs 512 --iters 20 --fused_physics
  python -m vmas_tpu_torch.examples.train_ppo --num_envs 64 --processes 2 --device cpu
"""

import argparse
import time

import torch

from vmas_tpu_torch.examples import RankGroup, add_rank_args, launch


def main(scenario="transport", num_envs=512, iters=50, horizon=32, lr=3e-4, seed=0, collect="auto",
         fused_physics=False, bf16=False, processes=0, device=None, rank=None, world_size=None,
         init_method=None, backend="gloo"):
    """Train and return the actor-critic (``processes=N``: run N ranks and
    return None)."""
    if processes:
        return launch("vmas_tpu_torch.examples.train_ppo", processes, dict(
            scenario=scenario, num_envs=num_envs, iters=iters, horizon=horizon, lr=lr, seed=seed,
            collect=collect, fused_physics=fused_physics, bf16=bf16, device=device))
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.parallel import distribute
    from vmas_tpu_torch.parallel.ppo import init_actor_critic, make_ppo_update, obs_dim_of

    with RankGroup(rank, world_size, init_method, backend):
        env = make_env(scenario, num_envs=num_envs, seed=seed, fused_physics=fused_physics, device=device)
        distribute(env)  # the env-axis mesh over the ranks (asserts divisibility)
        n = env.mesh.size()
        print(f"mesh: {n} ranks, {num_envs} envs ({env.num_envs}/rank) on {env.device}")
        gen = torch.Generator(device=env.device).manual_seed(seed)
        model = init_actor_critic(obs_dim_of(env), env.agents[0].action_size, generator=gen, device=env.device)
        update, make_optimizer = make_ppo_update(env, horizon=horizon, lr=lr, collect=collect,
                                                 compute_dtype=torch.bfloat16 if bf16 else None)
        optimizer = make_optimizer(model)
        state, steps = env.state, env.steps
        gen = torch.Generator(device=env.device).manual_seed(seed + 1)
        t0 = time.perf_counter()
        for it in range(iters):
            state, steps, metrics = update(model, optimizer, state, steps, gen)
            if it % 5 == 0 or it == iters - 1:
                print(f"iter {it:4d}  loss {float(metrics['loss']):+.4f}  "
                      f"mean_rew {float(metrics['mean_reward']):+.4f}  "
                      f"done_frac {float(metrics['episode_done_frac']):.3f}")
        dt = time.perf_counter() - t0  # the float() above waited for the device
        print(f"{iters} PPO iters x {horizon} steps x {num_envs} envs in {dt:.1f}s "
              f"= {iters * horizon * num_envs / dt:,.0f} env-steps/s (incl. learning)")
    return model


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default="transport")
    p.add_argument("--num_envs", type=int, default=512)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--collect", default="auto", choices=["auto", "rows", "step"])
    p.add_argument("--fused_physics", action="store_true",
                   help="the fused CUDA physics (needed for rows collection)")
    p.add_argument("--bf16", action="store_true", help="bf16 MLP activations")
    p.add_argument("--processes", type=int, default=0, help="run N gloo ranks on this machine")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    add_rank_args(p)
    main(**vars(p.parse_args()))
