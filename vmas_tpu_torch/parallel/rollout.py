"""Rollouts: many env steps per call.

Counterpart of vmas_tpu/parallel/rollout.py. ``lax.scan`` becomes a Python
loop. ``rollout_fn`` loops the environment's own step; ``rows_rollout_fn``
carries the fused kernel's row buffer from step to step, so one step is one
kernel launch: the action rows are decoded for the whole horizon up front,
each step writes its emit rows straight into its slice ``extras[t]`` of one
``[T, n_out, B]`` buffer, and ``unpack`` runs once over that buffer after
the loop. Both give the same trajectory for the same generator seed.

Not ported yet: policies with auxiliary outputs, autoreset, ``reset_every``,
``k_steps > 1``, ``rows_policy_rollout_fn``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _random_actions_for_horizon(env, generator, horizon):
    """Uniform random actions for all steps, per agent, drawn up front in
    the agents' full action spaces (as ``Environment.get_random_action``)."""
    dev, B = env.device, env.num_envs
    xs = []
    for a in env.agents:
        if env.continuous_actions:
            ranges = torch.as_tensor(a.u_range_array, device=dev)
            u = (torch.rand((horizon, B, a.action_size), generator=generator, device=dev) * 2 - 1) * ranges
            if env.world.dim_c != 0 and not a.silent:
                comm = torch.rand((horizon, B, env.world.dim_c), generator=generator, device=dev)
                u = torch.cat([u, comm], dim=-1)
            xs.append(u)
        else:
            space = env.get_agent_action_space(a)
            if env.multidiscrete_actions:
                cols = [
                    torch.randint(0, int(n), (horizon, B), generator=generator, device=dev)
                    for n in space.nvec
                ]
                xs.append(torch.stack(cols, dim=-1))
            else:
                xs.append(torch.randint(0, int(space.n), (horizon, B), generator=generator, device=dev))
    return tuple(xs)


def rollout_fn(env, policy: Optional[Callable] = None, horizon: int = 100):
    """Build ``run(state, steps, generator) -> (state', steps', traj)``
    stepping ``horizon`` env steps through the env's own step.

    ``policy(obs_tuple, generator) -> actions_tuple`` acts on the previous
    step's observations; the default draws uniform random actions.
    ``traj`` holds ``rewards [T, B, A]``, ``dones [T, B]`` and ``obs`` (a
    tuple of ``[T, B, obs_dim]`` per agent)."""

    def run(state, steps, generator):
        if policy is None:
            acts = _random_actions_for_horizon(env, generator, horizon)
        else:
            obs = env._observations(state)
        rews, dones, obs_t = [], [], []
        for t in range(horizon):
            actions = [a[t] for a in acts] if policy is None else policy(obs, generator)
            state, obs, r, terminated, truncated, _, steps = env._step_fn_raw(
                state, steps, actions, generator
            )
            rews.append(torch.stack(r, dim=-1))
            dones.append(terminated | truncated)
            obs_t.append(obs)
        traj = {
            "rewards": torch.stack(rews),
            "dones": torch.stack(dones),
            "obs": tuple(torch.stack([o[i] for o in obs_t]) for i in range(len(env.agents))),
        }
        return state, steps, traj

    return run


def rows_rollout_supported(env) -> bool:
    """Whether ``rows_rollout_fn`` can run this env: fused physics with a
    fused-outputs scenario declaring its scratch carry, noise-free
    unclamped (or discrete) actions, and a hook pipeline the kernel fully
    replaces (see fused.rows_step_supported)."""
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.scenario import BaseScenario

    sc = type(env.scenario)
    fo = env._fused_outputs
    return (
        env.world.fused
        and fo is not None
        and not env.grad_enabled
        and not (env.continuous_actions and env.clamp_action)
        and not any(
            (a.u_noise_array > 0).any() or (env.world.dim_c > 0 and not a.silent)
            for a in env.agents
        )
        and sc.post_rewards is BaseScenario.post_rewards
        and sc.process_action is BaseScenario.process_action
        and sc.pre_step is BaseScenario.pre_step
        and sc.post_step is BaseScenario.post_step
        and F.rows_step_supported(env.world, fo, env.agents)
    )


def _decode_horizon(env, agent, raw):
    """``Environment._decode_action``'s u math over a leading horizon axis
    (same ops per element, so bitwise the per-step decode): ``u [T, B,
    action_size]``. Noise-free unclamped actions, no comm."""
    import math

    dev = env.device
    u_range = torch.as_tensor(agent.u_range_array, device=dev)
    u_mult = torch.as_tensor(agent.u_multiplier_array, device=dev)
    if env.continuous_actions:
        u = raw.detach().to(torch.float32)[..., : agent.action_size]
    else:
        action = raw
        if action.ndim == 2:  # flat Discrete: [T, B]
            action = action[..., None]
        nvec = list(agent.discrete_action_nvec)
        if not env.multidiscrete_actions:
            flat = torch.clamp(action[..., 0].to(torch.int64), 0, math.prod(nvec) - 1)
            cols = []
            for i in range(len(nvec)):
                n = math.prod(nvec[i + 1:])
                cols.append(flat // n)
                flat = flat % n
            action = torch.stack(cols, dim=-1)
        action = action.to(torch.int64)
        us = []
        for j, n in enumerate(nvec):
            a = action[..., j]
            if n % 2 != 0:
                stay = a == 0
                decrement = (a > 0) & (a <= n // 2)
                a = torch.where(stay, n // 2, torch.where(decrement, a - 1, a))
            u_max = u_range[j]
            us.append((a.to(torch.float32) / (n - 1)) * (2 * u_max) - u_max)
        u = torch.stack(us, dim=-1)
    return u * u_mult[None, None]


def rows_rollout_fn(env, horizon: int = 100):
    """Rows-carried rollout with random actions: same contract and the same
    trajectory as ``rollout_fn(env, horizon=...)``, with one fused-kernel
    launch per step and nothing else between launches."""
    from vmas_tpu_torch.core import fused as F

    assert rows_rollout_supported(env), (
        "rows_rollout_fn: env not eligible -- needs fused_physics=True, a "
        "fused-outputs scenario declaring carry_extra_idx, holonomic "
        "noise-free agents (continuous unclamped or discrete), no scripted "
        "agents, no process_action/post_rewards overrides; use rollout_fn"
    )
    world, fo, agents = env.world, env._fused_outputs, env.agents
    act_slots = [a.index for a in agents]
    step = F.make_rows_step(world, fo, act_slots)
    B, n_out = env.num_envs, int(fo.n_out)

    def run(state, steps, generator):
        acts = _random_actions_for_horizon(env, generator, horizon)
        us = [_decode_horizon(env, a, acts[i]) for i, a in enumerate(agents)]
        ax = torch.stack([u[..., 0] for u in us], dim=1)  # [T, A, B]
        ay = torch.stack([u[..., 1] for u in us], dim=1)
        act_rows = torch.cat([ax, ay], dim=1).contiguous()  # [T, 2A, B]

        carry = F.pack_carry(world, state, fo)
        extras = torch.empty((horizon, n_out, B), dtype=torch.float32, device=env.device)
        for t in range(horizon):
            carry, _ = step(carry, act_rows[t], extras[t])

        state_out = F.unpack_carry(world, carry, state)
        obs, rews, terminated, updates = fo.unpack(extras, state)
        if env.max_steps is not None:
            steps_t = steps[None] + 1 + torch.arange(horizon, device=env.device)[:, None]
            truncated = steps_t >= env.max_steps
        else:
            truncated = torch.zeros_like(terminated)
        # the final state mirrors the step pipeline's: last decoded u, last
        # step's scratch updates
        for a, u in zip(agents, us):
            state_out = a.set_u(state_out, u[-1])
        state_out = state_out.replace(
            scenario={**state_out.scenario, **{k: v[-1] for k, v in updates.items()}}
        )
        traj = {"rewards": torch.stack(rews, dim=-1), "dones": terminated | truncated, "obs": obs}
        return state_out, steps + horizon, traj

    return run
