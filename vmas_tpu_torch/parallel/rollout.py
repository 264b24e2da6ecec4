"""Rollouts: many env steps per call.

Counterpart of vmas_tpu/parallel/rollout.py. ``lax.scan`` becomes a Python
loop. ``rollout_fn`` loops the environment's own step; ``rows_rollout_fn``
carries the fused kernel's row buffer from step to step, so ``k_steps``
env steps are one kernel launch: the action rows are decoded for the whole
horizon up front, each launch writes its output rows straight into its
slice ``extras[t:t+k_steps]`` of one ``[T, n_out + n_ctrl_out, B]`` buffer,
and ``unpack`` runs once over that buffer after the loop. Both give the same
trajectory for the same generator seed.

Not ported yet: policies with auxiliary outputs, autoreset, ``reset_every``,
``rows_policy_rollout_fn``.
"""

from __future__ import annotations

import math
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
            nvec = env.discrete_action_nvec(a)
            if env.multidiscrete_actions:
                cols = [torch.randint(0, n, (horizon, B), generator=generator, device=dev) for n in nvec]
                xs.append(torch.stack(cols, dim=-1))
            else:
                xs.append(torch.randint(0, math.prod(nvec), (horizon, B), generator=generator, device=dev))
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
    replaces (see fused.rows_step_supported). A scenario's process_action
    override is allowed where its outputs declare it a no-op for this
    config (``process_action_noop``) or realize it in the kernel's rows
    (``process_act_rows``: the PID velocity controller of give_way,
    multi_give_way and joint_passage with ``use_controller=True``). Not
    eligible yet, and run through ``rollout_fn`` (the fused step, K1, per
    ``env.step``) instead: outputs whose unpack reads per-step state
    (``unpack_reads``: the noisy configs)."""
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
        and (
            sc.process_action is BaseScenario.process_action
            or getattr(fo, "process_action_noop", False)
            or getattr(fo, "process_act_rows", None) is not None
        )
        and not getattr(fo, "unpack_reads", ())
        and sc.pre_step is BaseScenario.pre_step
        and sc.post_step is BaseScenario.post_step
        and F.rows_step_supported(env.world, fo, env.agents)
    )


def _decode_horizon(env, agent, raw):
    """``Environment._decode_action``'s u math over a leading horizon axis
    (same ops per element, so bitwise the per-step decode): ``u [T, B,
    action_size]``. Noise-free unclamped actions, no comm."""
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


def _apply_ctrl_finish(world, fo, state_out, carry, state0):
    """The final carry's controller rows (the in-kernel process_action's
    memory, e.g. the PID integrator) -> scenario scratch, via the
    scenario's ``ctrl_updates``."""
    from vmas_tpu_torch.core import fused as F

    if not fo.n_ctrl:
        return state_out
    base = F.rows_layout(world, fo) - fo.n_ctrl
    updates = fo.ctrl_updates(carry[base:base + fo.n_ctrl], state0.scenario)
    return state_out.replace(scenario={**state_out.scenario, **updates})


def _last_us(fo, us_last, extras):
    """The final state's per-agent u: the decoded action, unless the
    scenario's in-kernel process_action rewrote it (``ctrl_u_idx`` names the
    output rows holding it: the hook pipeline stores the controller's
    output in state.u, so the rows path does too)."""
    idx = getattr(fo, "ctrl_u_idx", None)
    if idx is None:
        return us_last
    return [torch.stack([extras[-1, ix], extras[-1, iy]], dim=-1) for ix, iy in idx]


def rows_rollout_fn(env, horizon: int = 100, k_steps: int = 1):
    """Rows-carried rollout with random actions: same contract and the same
    trajectory as ``rollout_fn(env, horizon=...)``, with one fused-kernel
    launch per ``k_steps`` steps and nothing else between launches.
    ``k_steps`` must divide ``horizon``."""
    from vmas_tpu_torch.core import fused as F

    assert rows_rollout_supported(env), (
        "rows_rollout_fn: env not eligible -- needs fused_physics=True, a "
        "fused-outputs scenario declaring carry_extra_idx, holonomic "
        "noise-free agents (continuous unclamped or discrete), no scripted "
        "agents, no post_rewards override, no process_action override unless "
        "declared a no-op or realized in the kernel, no unpack_reads; use rollout_fn"
    )
    K = int(k_steps)
    assert K >= 1 and horizon % K == 0, f"k_steps ({k_steps}) must divide horizon ({horizon})"
    world, fo, agents = env.world, env._fused_outputs, env.agents
    act_slots = [a.index for a in agents]
    step = F.make_rows_step(world, fo, act_slots, k_steps=K)
    B, n_tot = env.num_envs, int(fo.n_out) + int(fo.n_ctrl_out)
    A2 = 2 * len(agents)

    def run(state, steps, generator):
        acts = _random_actions_for_horizon(env, generator, horizon)
        us = [_decode_horizon(env, a, acts[i]) for i, a in enumerate(agents)]
        ax = torch.stack([u[..., 0] for u in us], dim=1)  # [T, A, B]
        ay = torch.stack([u[..., 1] for u in us], dim=1)
        act_rows = torch.cat([ax, ay], dim=1).contiguous()  # [T, 2A, B]

        carry = F.pack_carry(world, state, fo)
        extras = torch.empty((horizon, n_tot, B), dtype=torch.float32, device=env.device)
        # K steps' rows are contiguous in both buffers: views, no copies
        for t in range(0, horizon, K):
            carry, _ = step(carry, act_rows[t:t + K].view(K * A2, B), extras[t:t + K].view(K * n_tot, B))

        state_out = F.unpack_carry(world, carry, state)
        obs, rews, terminated, updates = fo.unpack(extras, state)
        if env.max_steps is not None:
            steps_t = steps[None] + 1 + torch.arange(horizon, device=env.device)[:, None]
            truncated = steps_t >= env.max_steps
        else:
            truncated = torch.zeros_like(terminated)
        # the final state mirrors the step pipeline's: the last step's u
        # (the controller's output where the kernel ran one), its scratch
        # updates and the controller's memory
        for a, u in zip(agents, _last_us(fo, [u[-1] for u in us], extras)):
            state_out = a.set_u(state_out, u)
        state_out = state_out.replace(
            scenario={**state_out.scenario, **{k: v[-1] for k, v in updates.items()}}
        )
        state_out = _apply_ctrl_finish(world, fo, state_out, carry, state)
        traj = {"rewards": torch.stack(rews, dim=-1), "dones": terminated | truncated, "obs": obs}
        return state_out, steps + horizon, traj

    return run
