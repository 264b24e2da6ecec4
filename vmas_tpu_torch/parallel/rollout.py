"""Rollouts: many env steps per call.

Counterpart of vmas_tpu/parallel/rollout.py. ``lax.scan`` becomes a Python
loop. ``rollout_fn`` loops the environment's own step; ``rows_rollout_fn``
carries the fused kernel's row buffer from step to step, so ``k_steps``
env steps are one kernel launch: the action rows are decoded for the whole
horizon up front, each launch writes its output rows straight into its
slice ``extras[t:t+k_steps]`` of one ``[T, n_out + n_ctrl_out, B]`` buffer,
and ``unpack`` runs once over that buffer after the loop.
``rows_policy_rollout_fn`` does the same with a policy between launches:
the policy acts on the observations of the previous launch's output rows.

Randomness: each call forks two generators from the caller's (one for the
policy or the random actions, one for the env steps and resets), as the JAX
rollouts split their key, so the policy's draws do not depend on what the
steps draw. ``rollout_fn`` and the rows rollouts therefore give the same
trajectory for the same generator seed, with random actions or a policy.

Comm worlds (the MPE worlds with speaking agents) take the rows paths:
the comm actions are decoded with the physical ones, and where the outputs'
``unpack`` reads the comm state (``unpack_reads = ("c",)``) it is given the
per-step ``c`` the step pipeline would hold; where it reads the actions
(``"u"``: dropout's energy term) it is given the per-step decoded actions
the paths hold. A scenario whose ``post_rewards`` only re-merges scratch
that ``unpack`` already merged and touches nothing a step reads
(``post_rewards_rollout_safe``: dispersion, dropout) has it applied once,
to the final state; a pure step counter of the scratch
(``step_count_keys``: joint_passage_size's ``t``) is set to its value at
the start plus the horizon.

Noise: where an agent's actions or comm are noisy (``u_noise``,
``c_noise``) or ``unpack`` draws observation noise (``unpack_reads =
("obs_key",)``), the rows paths draw from the steps' generator, before the
launch loop, exactly what ``Environment._step_fn_raw`` draws from it at
each step and in its order (``Environment._step_draws``: the step's
observation seed, then per agent its action noise and its comm noise), add
the noise to the decoded actions as the step adds it
(``Environment._add_noise``), and hand each step's observation seed to
``unpack`` (``BaseScenario.obs_seed``), which then runs once per step; so
they give ``rollout_fn``'s trajectory bitwise for the same generator seed.

Sensors: where ``unpack`` reads the entities' state (``unpack_reads =
("state",)``: navigation's and flocking's Lidar), ``rows_rollout_fn`` keeps
each step's carry rows (``k_steps`` 1 only), rebuilds each step's state
from them after the loop and runs ``unpack``, and so the Lidar, over all
T x B env-steps at once, in chunks of steps (``_STATE_CHUNK`` env-steps a
chunk); the policy rollout refuses such envs, as the JAX package's does.
Scripted agents whose actions are a function of the step alone
(``script_slots``/``script_us``: flocking's circling target) have them
computed for the horizon up front and ride the action rows after the
policy agents'. A script that runs inside the kernel
(``kernel_script_slots``: football's ball) gets its final u from the last
step's output rows (``kernel_script_u``), and a scenario's rewrite of the
decoded actions (``decode_transform``: football's red team mirrors x) is
applied after the action noise on both rows paths, where ``env.step``'s
``process_action`` applies it.

Spans (``profiling.span``): a rows rollout's call is ``vmas.rows.call``,
tiled by ``vmas.rows.actions`` (the random-action rollout's draws, decode
and action rows), ``vmas.rows.loop`` (the launches; in the policy rollout
each step is a ``vmas.rows.policy_step``) and ``vmas.rows.finish``
(``_finish_rows_rollout``). Where the policy rollout's steps are a CUDA
graph (``make_ppo_update``'s collection on a CUDA env), its loop is a
``vmas.rows.capture`` (the eager steps, the capture and the graph's
instantiation; recorded in every run) or a ``vmas.rows.replay``, and a
replay runs no step's host work, so records no ``vmas.rows.policy_step``
and no ``vmas.rows.launch``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from vmas_tpu_torch.core.utils import tree_leaves, tree_map
from vmas_tpu_torch.environment.environment import _obs_seed
from vmas_tpu_torch.profiling import span


def _fork(generator, n):
    """``n`` generators on ``generator``'s device, each seeded from it (the
    caller's generator advances by ``n`` draws)."""
    out = []
    for _ in range(n):
        g = torch.Generator(device=generator.device)
        g.manual_seed(_obs_seed(generator))
        out.append(g)
    return out


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


def _noisy(env):
    """Whether a step of ``env`` draws noise from its generator beyond the
    observation seed (noisy actions or comm), or its fused outputs' unpack
    reads the observation-noise streams."""
    fo = env._fused_outputs
    reads = getattr(fo, "unpack_reads", ()) if fo is not None else ()
    return "obs_key" in reads or any(u is not None or c is not None for u, c in env._noise_shapes())


def _stack_tree(xs):
    """A list of per-step pytrees (dicts, tuples, lists of tensors) -> one
    pytree of tensors stacked over a leading T axis."""
    x0 = xs[0]
    if isinstance(x0, dict):
        return {k: _stack_tree([x[k] for x in xs]) for k in x0}
    if isinstance(x0, (tuple, list)):
        return type(x0)(_stack_tree([x[i] for x in xs]) for i in range(len(x0)))
    return torch.stack(xs)


def _where_tree(mask, a, b):
    """``a`` where the [B] ``mask`` holds, else ``b``, leaf by leaf of two
    pytrees of [B, ...] tensors (an agent's observation may be a dict)."""
    if isinstance(a, dict):
        return {k: _where_tree(mask, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_where_tree(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask.view((-1,) + (1,) * (a.ndim - 1)), a, b)


def _cat_tree(xs):
    """Pytrees of [T_i, ...] tensors -> one, concatenated over T."""
    x0 = xs[0]
    if isinstance(x0, dict):
        return {k: _cat_tree([x[k] for x in xs]) for k in x0}
    if isinstance(x0, (tuple, list)):
        return type(x0)(_cat_tree([x[i] for x in xs]) for i in range(len(x0)))
    return torch.cat(xs)


def rollout_fn(env, policy: Optional[Callable] = None, horizon: int = 100,
               autoreset: bool = False, policy_aux: bool = False):
    """Build ``run(state, steps, generator) -> (state', steps', traj)``
    stepping ``horizon`` env steps through the env's own step.

    ``policy(obs_tuple, generator) -> actions_tuple`` acts on the previous
    step's observations; the default draws uniform random actions.
    ``traj`` holds ``rewards [T, B, A]``, ``dones [T, B]`` and ``obs`` (a
    tuple of ``[T, B, obs_dim]`` per agent).

    Arguments of ``run`` after the generator go to the policy before the
    observations: ``run(state, steps, generator, model)`` calls ``policy(model,
    obs, generator)``, so that one built rollout serves every model.

    ``policy_aux=True``: the policy returns ``(actions, aux)``; the per-step
    ``aux`` (a pytree of tensors) is recorded stacked over T in
    ``traj["policy_aux"]``, and the initial observations in
    ``traj["obs0"]``.

    ``autoreset=True``: after each step the envs whose ``terminated |
    truncated`` flag is set are re-spawned (the env's masked reset), their
    step counters zeroed, and their recorded and carried observations are
    the post-reset ones; the done flag still marks the boundary."""
    assert not (policy_aux and policy is None), "policy_aux needs an explicit policy returning (actions, aux)"

    def run(state, steps, generator, *args):
        g_pol, g_step = _fork(generator, 2)
        if policy is None:
            acts = _random_actions_for_horizon(env, g_pol, horizon)
        else:
            obs = obs0 = env._observations(state)
        rews, dones, obs_t, auxs = [], [], [], []
        for t in range(horizon):
            if policy is None:
                actions = [a[t] for a in acts]
            elif policy_aux:
                actions, aux = policy(*args, obs, g_pol)
                auxs.append(aux)
            else:
                actions = policy(*args, obs, g_pol)
            state, obs, r, terminated, truncated, _, steps = env._step_fn_raw(state, steps, actions, g_step)
            done = terminated | truncated
            if autoreset:
                state, steps, obs_reset, _, _, _ = env._reset_fn(state, steps, g_step, done)
                obs = _where_tree(done, obs_reset, obs)
            rews.append(torch.stack(r, dim=-1))
            dones.append(done)
            obs_t.append(obs)
        traj = {
            "rewards": torch.stack(rews),
            "dones": torch.stack(dones),
            "obs": tuple(_stack_tree([o[i] for o in obs_t]) for i in range(len(env.agents))),
        }
        if policy_aux:
            traj["policy_aux"] = _stack_tree(auxs)
            traj["obs0"] = obs0
        return state, steps, traj

    return run


def rollout(env, policy: Optional[Callable] = None, horizon: int = 100, generator=None):
    """Run a rollout on the env's current state and write the final state
    back to ``env.state`` and ``env.steps``; returns the trajectory.

    Rows-eligible envs (``rows_rollout_supported``) take the rows paths
    (``rows_rollout_fn``, or ``rows_policy_rollout_fn`` with a policy),
    which give the same trajectory as ``rollout_fn``, unless the scenario's
    outputs opt out with ``rows_auto = False``; other envs take
    ``rollout_fn``. ``generator`` defaults to the env's own."""
    generator = env.generator if generator is None else generator
    fo = env._fused_outputs
    rows_ok = (
        rows_rollout_supported(env)
        and getattr(fo, "rows_auto", True)
        # the policy rows path refuses per-step state reads and scripts
        and (policy is None or ("state" not in getattr(fo, "unpack_reads", ())
                                and not getattr(fo, "script_slots", ())))
    )
    if not rows_ok:
        build = rollout_fn(env, policy, horizon)
    elif policy is None:
        build = rows_rollout_fn(env, horizon)
    else:
        build = rows_policy_rollout_fn(env, policy, horizon)
    env.state, env.steps, traj = build(env.state, env.steps, generator)
    return traj


def rows_rollout_supported(env) -> bool:
    """Whether ``rows_rollout_fn`` can run this env: fused physics with a
    fused-outputs scenario declaring its scratch carry, noise-free
    unclamped (or discrete) actions, and a hook pipeline the kernel fully
    replaces (see fused.rows_step_supported). A scenario's process_action
    override is allowed where its outputs declare it a no-op for this
    config (``process_action_noop``) or realize it in the kernel's rows
    (``process_act_rows``: the PID velocity controller of give_way,
    multi_give_way and joint_passage with ``use_controller=True``, football's
    ball script, with its red team's mirror as a ``decode_transform``), a
    pre_step override where they declare it a no-op for this config
    (``pre_step_noop``), and a post_rewards override where they declare it
    ``post_rewards_rollout_safe`` (applied once to the final state). Speaking agents are allowed: their
    comm actions are decoded with the physical ones, and an ``unpack`` that
    reads the comm state (``unpack_reads = ("c",)``, where some policy agent
    speaks) gets the per-step ``c``; one that reads the actions (``"u"``)
    gets the per-step decoded u. Noisy actions and comm (``u_noise > 0``,
    ``c_noise > 0``) and outputs whose unpack draws observation noise
    (``"obs_key"``: the noisy configs of give_way, multi_give_way,
    joint_passage and joint_passage_size) are eligible: the rows paths draw
    the steps' noise streams as ``env.step`` draws them
    (``Environment._step_draws``). An unpack that reads the entities' state
    (``"state"``: a Lidar) is eligible alone, the random-action path
    rebuilding each step's state from its carry rows; so are scripted
    agents whose outputs declare their actions computable up front
    (``script_slots``, ``fused.rows_step_supported``), and so are scripted
    agents whose script runs in the kernel (``kernel_script_slots``). Not
    eligible, and run
    through ``rollout_fn`` (the fused step, K1, per ``env.step``) instead:
    clamped actions, other scripted or non-holonomic agents, dynamic
    gravity, hooks the kernel does not replace (``finish_obs`` among them),
    and outputs whose unpack reads any other per-step state."""
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.scenario import BaseScenario

    sc = type(env.scenario)
    fo = env._fused_outputs
    reads = set(getattr(fo, "unpack_reads", ()))
    speaks = [a for a in env.agents if env.world.dim_c > 0 and not a.silent]
    return (
        env.world.fused
        and fo is not None
        and not env.grad_enabled
        and not (env.continuous_actions and env.clamp_action)
        and (sc.post_rewards is BaseScenario.post_rewards or getattr(fo, "post_rewards_rollout_safe", False))
        and (
            sc.process_action is BaseScenario.process_action
            or getattr(fo, "process_action_noop", False)
            or getattr(fo, "process_act_rows", None) is not None
        )
        and type(fo).finish_obs is F.FusedOutputs.finish_obs
        and reads <= {"c", "u", "obs_key", "state"}
        and ("state" not in reads or reads == {"state"})
        and ("c" not in reads or bool(speaks))
        and (sc.pre_step is BaseScenario.pre_step or getattr(fo, "pre_step_noop", False))
        and sc.post_step is BaseScenario.post_step
        and F.rows_step_supported(env.world, fo, env.agents)
    )


def _decoder(env, agent):
    """``Environment._decode_action``'s math over any leading axes (same
    ops per element, so bitwise the per-step decode), as a function ``raw
    -> (u [..., B, action_size], uc)`` with its constants on the env's
    device; ``uc`` is the comm action [..., B, dim_c] of a speaking agent in
    a comm world (continuous, or the one-hot of its discrete comm index),
    else None. Unclamped actions, before their noise
    (``Environment._add_noise``)."""
    dev = env.device
    dim_c = env.world.dim_c
    has_comm = dim_c > 0 and not agent.silent
    u_range = torch.as_tensor(agent.u_range_array, device=dev)
    u_mult = torch.as_tensor(agent.u_multiplier_array, device=dev)
    nvec = list(agent.discrete_action_nvec)
    radix = nvec + ([dim_c] if has_comm else [])

    def decode(raw):
        if env.continuous_actions:
            raw = raw.detach().to(torch.float32)
            return raw[..., : agent.action_size] * u_mult, raw[..., agent.action_size:] if has_comm else None
        action = raw
        if action.ndim == 2:  # flat Discrete: [T, B]
            action = action[..., None]
        if not env.multidiscrete_actions:
            flat = torch.clamp(action[..., 0].to(torch.int64), 0, math.prod(radix) - 1)
            cols = []
            for i in range(len(radix)):
                n = math.prod(radix[i + 1:])
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
        uc = None
        if has_comm:
            uc = torch.nn.functional.one_hot(action[..., len(nvec)], dim_c).to(torch.float32)
        return torch.stack(us, dim=-1) * u_mult, uc

    return decode


def _comm_state(state, agents, ucs):
    """The comm state ``c`` after steps whose comm actions are ``ucs`` (per
    agent of ``agents``, [..., B, dim_c] or None): physics copies a
    speaking agent's ``uc`` into ``c``, and a silent agent's ``c`` keeps its
    value. With a leading T axis on the ``ucs``, [T, B, A, dim_c]."""
    lead = next(uc.shape[:-2] for uc in ucs if uc is not None)
    c = state.c.expand(lead + state.c.shape).clone()
    for a, uc in zip(agents, ucs):
        if uc is not None:
            c[..., a.slot, :] = uc
    return c


def _unpack_state(env, state, us=None, c=None):
    """The state ``unpack`` reads: ``state`` with the per-step comm state
    ``c`` where it reads ``"c"``, and each policy agent's per-step decoded
    actions ``us`` (a leading T axis or none) as its u where it reads
    ``"u"``, as the step pipeline holds them after each step."""
    reads = getattr(env._fused_outputs, "unpack_reads", ())
    if "c" in reads:
        state = state.replace(c=c)
    if "u" in reads:
        for a, u in zip(env.agents, us):
            state = a.set_u(state, u)
    return state


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


def _kernel_script_us(world, fo, extras):
    """The final u of each scripted agent whose script runs in the kernel
    (football's ball): ``(agent, u)`` from the last step's output rows that
    ``kernel_script_u`` names, ``(entity index, x row, y row)``."""
    out = []
    for e, ix, iy in getattr(fo, "kernel_script_u", ()):
        agent = next(a for a in world.agents if a.index == int(e))
        out.append((agent, torch.stack([extras[-1, int(ix)], extras[-1, int(iy)]], dim=-1)))
    return out


# env-steps per chunk of the rebuilt-state unpack: navigation's Lidar at
# its defaults holds some 20 live [chunk, 3, 12, 2] f32 intermediates, each
# 150 MB at this size
_STATE_CHUNK = 1 << 19


def _unpack_over_states(env, fo, extras, carries, state):
    """``unpack`` of the output rows ``extras`` [T, n_out, B] against each
    step's state, rebuilt from its carry rows ``carries`` [T, R_in, B]: the
    T x B env-steps of a chunk of steps as one batch (the rows [n_out,
    T_c * B], the state's entity fields [T_c * B, ...]), whose results are
    laid out again over [T, B, ...]."""
    from vmas_tpu_torch.core import fused as F

    T, n_out, B = extras.shape
    step_chunk = max(1, _STATE_CHUNK // B)
    parts = []
    for t0 in range(0, T, step_chunk):
        e, c = extras[t0:t0 + step_chunk], carries[t0:t0 + step_chunk]
        n = e.shape[0]
        flat = lambda x: x.permute(1, 0, 2).reshape(x.shape[1], n * B)
        out = fo.unpack(flat(e), F.unpack_carry(env.world, flat(c), state))
        parts.append(_map_tree(lambda x: x.reshape((n, B) + x.shape[1:]), out))
    return _cat_tree(parts)


def _map_tree(fn, x):
    """``fn`` on every tensor of a pytree of dicts, tuples and lists."""
    if isinstance(x, dict):
        return {k: _map_tree(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tree(fn, v) for v in x)
    return fn(x)


def _finish_rows_rollout(env, state, steps, carry, extras, us_t, horizon, ucs_last=(), c_t=None, seeds=None,
                         carries=None, script_last=()):
    """The rows rollouts' finale: one ``unpack`` over all the output rows
    (given the per-step comm state ``c_t`` [T, B, A, dim_c] where it reads
    ``c``, the per-step decoded actions ``us_t``, per agent [T, B, 2],
    where it reads ``u``, and each step's state, rebuilt from its carry
    rows ``carries``, where it reads ``state``), the truncation flags, and a
    final state that mirrors the step pipeline's (the last step's u, or the
    controller's output where the kernel ran one, and each scripted agent's
    of ``script_last``, ``(agent, u)`` pairs, the last comm action in
    ``uc`` and ``c`` of each speaking agent, its scratch updates with each
    step counter at its start value plus ``horizon``, and the controller's
    memory, then the scenario's post_rewards, once). With ``seeds`` (each
    step's observation seed, ``Environment._step_draws``) where ``unpack`` draws
    observation noise, it runs once per step, after the scenario's
    ``obs_seed`` is set to the step's seed, as ``env.step`` runs it; the
    scenario is left with the last step's seed."""
    from vmas_tpu_torch.core import fused as F

    with span("vmas.rows.finish", device=env.device):
        world, fo = env.world, env._fused_outputs
        reads = getattr(fo, "unpack_reads", ())
        state_out = F.unpack_carry(world, carry, state)
        if carries is not None:
            obs, rews, terminated, updates = _unpack_over_states(env, fo, extras, carries, state)
        elif seeds is not None and "obs_key" in reads:
            outs = []
            for t in range(horizon):
                env.scenario.obs_seed = seeds[t]
                u_step = [u[t] for u in us_t] if "u" in reads else None
                outs.append(fo.unpack(extras[t], _unpack_state(env, state, u_step, None if c_t is None else c_t[t])))
            obs, rews, terminated, updates = _stack_tree(outs)
        else:
            obs, rews, terminated, updates = fo.unpack(extras, _unpack_state(env, state, us_t, c_t))
        if seeds is not None:
            env.scenario.obs_seed = seeds[-1]
        us_last = [u[-1] for u in us_t]
        if env.max_steps is not None:
            steps_t = steps[None] + 1 + torch.arange(horizon, device=env.device)[:, None]
            truncated = steps_t >= env.max_steps
        else:
            truncated = torch.zeros_like(terminated)
        for a, u in list(zip(env.agents, _last_us(fo, us_last, extras))) + list(script_last) + _kernel_script_us(
                world, fo, extras):
            state_out = a.set_u(state_out, u)
        if any(uc is not None for uc in ucs_last):
            uc, c = state_out.uc.clone(), state_out.c.clone()
            for a, v in zip(env.agents, ucs_last):
                if v is not None:
                    uc[:, a.slot] = v
                    c[:, a.slot] = v
            state_out = state_out.replace(uc=uc, c=c)
        counters = getattr(fo, "step_count_keys", ())
        last = {k: v[-1] for k, v in updates.items() if k not in counters}
        # a pure step counter: each step's unpack added one to the value at the
        # start; the step pipeline's unit increments are exact f32 integer adds
        last.update({k: state_out.scenario[k] + float(horizon) for k in counters})
        state_out = state_out.replace(scenario={**state_out.scenario, **last})
        state_out = _apply_ctrl_finish(world, fo, state_out, carry, state)
        # identity, or declared safe to apply once (post_rewards_rollout_safe)
        state_out = env.scenario.post_rewards(state_out)
        traj = {"rewards": torch.stack(rews, dim=-1), "dones": terminated | truncated, "obs": obs}
        return state_out, steps + horizon, traj


def _chunked_reset_rollout(env, run_chunk, horizon, reset_every):
    """Wrap a rows rollout's ``run`` with synchronized resets every
    ``reset_every`` steps: the rows carry cannot reset some envs mid-loop,
    so episodes are fixed-length and every env resets at the boundary. The
    boundary step's observations are the post-reset ones and its done flag
    is True for every env (the convention of ``rollout_fn``'s autoreset),
    so returns, GAE masks and PPO's observation/action alignment hold
    across chunks."""
    assert reset_every >= 1 and horizon % reset_every == 0, (
        f"reset_every ({reset_every}) must divide horizon ({horizon})"
    )

    def run(state, steps, generator, *args):
        parts = []
        for _ in range(horizon // reset_every):
            state, steps, traj = run_chunk(state, steps, generator, *args)
            state, steps, obs_reset, _, _, _ = env._reset_fn(state, steps, generator, None)
            traj["obs"] = tuple(torch.cat([o[:-1], o_r[None]]) for o, o_r in zip(traj["obs"], obs_reset))
            traj["dones"] = traj["dones"].clone()
            traj["dones"][-1] = True
            parts.append(traj)
        out = {k: _cat_tree([p[k] for p in parts]) for k in ("rewards", "dones", "obs")}
        if "policy_aux" in parts[0]:
            out["policy_aux"] = _cat_tree([p["policy_aux"] for p in parts])
            out["obs0"] = parts[0]["obs0"]
        return state, steps, out

    return run


_NOT_ELIGIBLE = (
    "not eligible -- needs fused_physics=True, a fused-outputs scenario declaring carry_extra_idx, "
    "holonomic agents (continuous unclamped or discrete), no scripted agents unless declared "
    "precomputable (script_slots) or run in the kernel (kernel_script_slots), no post_rewards override unless "
    "declared post_rewards_rollout_safe, no process_action or pre_step override unless declared a no-op or "
    "realized in the kernel, no finish_obs, no "
    "unpack_reads but the comm state, the actions, the observation noise or the state alone; use rollout_fn"
)


def rows_rollout_fn(env, horizon: int = 100, k_steps: int = 1, reset_every: Optional[int] = None):
    """Rows-carried rollout with random actions: same contract and the same
    trajectory as ``rollout_fn(env, horizon=...)``, with one fused-kernel
    launch per ``k_steps`` steps and nothing else between launches.
    ``k_steps`` must divide ``horizon``, and be 1 where ``unpack`` reads the
    state (each step's carry rows are kept). ``reset_every=N`` resets every
    env every N steps (``_chunked_reset_rollout``)."""
    from vmas_tpu_torch.core import fused as F

    if reset_every is not None:
        chunk = rows_rollout_fn(env, reset_every, k_steps)
        return _chunked_reset_rollout(env, chunk, horizon, reset_every)
    assert rows_rollout_supported(env), "rows_rollout_fn: env " + _NOT_ELIGIBLE
    K = int(k_steps)
    assert K >= 1 and horizon % K == 0, f"k_steps ({k_steps}) must divide horizon ({horizon})"
    world, fo, agents = env.world, env._fused_outputs, env.agents
    reads_state = "state" in getattr(fo, "unpack_reads", ())
    assert K == 1 or not reads_state, (
        "k_steps>1 cannot record per-step carries (navigation's Lidar reconstruction needs them) -- use k_steps=1"
    )
    # the scripted agents computed up front ride the action rows after the
    # policy agents'
    script_slots = tuple(getattr(fo, "script_slots", ()))
    script_agents = [a for e in script_slots for a in world.agents if a.index == e]
    act_slots = [a.index for a in agents] + list(script_slots)
    step = F.make_rows_step(world, fo, act_slots, k_steps=K)
    B, n_tot = env.num_envs, int(fo.n_out) + int(fo.n_ctrl_out)
    A2 = 2 * len(act_slots)
    reads_c = "c" in getattr(fo, "unpack_reads", ())
    noisy = _noisy(env)
    transform = getattr(fo, "decode_transform", None)

    def run(state, steps, generator):
        with span("vmas.rows.call", device=env.device):
            with span("vmas.rows.actions"):
                g_act, g_step = _fork(generator, 2)
                acts = _random_actions_for_horizon(env, g_act, horizon)
                us, ucs = zip(*(_decoder(env, a)(acts[i]) for i, a in enumerate(agents)))
                seeds = None
                if noisy:
                    seeds, noise = env._step_draws(g_step, horizon)
                    us, ucs = zip(*(env._add_noise(a, u, uc, n) for a, u, uc, n in zip(agents, us, ucs, noise)))
                if transform is not None:
                    us = transform(us)
                script_us = list(fo.script_us(state, horizon)) if script_slots else []
                all_us = list(us) + script_us
                ax = torch.stack([u[..., 0] for u in all_us], dim=1)  # [T, A, B]
                ay = torch.stack([u[..., 1] for u in all_us], dim=1)
                act_rows = torch.cat([ax, ay], dim=1).contiguous()  # [T, 2A, B]
                # the per-step comm state, where unpack reads it
                c_t = _comm_state(state, agents, ucs) if reads_c else None

                carry = F.pack_carry(world, state, fo)
                extras = torch.empty((horizon, n_tot, B), dtype=torch.float32, device=env.device)
                # each step's carry rows, where unpack rebuilds each step's state
                carries = torch.empty((horizon,) + tuple(carry.shape), device=env.device) if reads_state else None
            with span("vmas.rows.loop", device=env.device):
                # K steps' rows are contiguous in both buffers: views, no copies
                for t in range(0, horizon, K):
                    carry, _ = step(carry, act_rows[t:t + K].view(K * A2, B), extras[t:t + K].view(K * n_tot, B),
                                    None if carries is None else carries[t])
            return _finish_rows_rollout(env, state, steps, carry, extras, us, horizon,
                                        [None if uc is None else uc[-1] for uc in ucs], c_t, seeds, carries,
                                        [(a, u[-1]) for a, u in zip(script_agents, script_us)])

    return run


def rows_policy_rollout_fn(env, policy: Callable, horizon: int = 100, policy_aux: bool = False,
                           reset_every: Optional[int] = None):
    """Rows-carried policy rollout: same contract and the same trajectory as
    ``rollout_fn(env, policy, horizon, policy_aux=policy_aux)`` for
    rows-eligible envs. Each step is the policy on the observations of the
    previous step's output rows (the env's observations of the initial
    state at t=0), the decode of its actions into the ``[2A, B]`` action
    rows, one fused-kernel launch writing into ``extras[t]``, and the
    observations of that step's rows (``unpack``). After the loop, one
    ``unpack`` over all the rows gives the trajectory, as in
    ``rows_rollout_fn``.

    No gradient flows through it (the kernel is forward-only; it runs
    under ``torch.no_grad``): it collects experience, and the policy is
    fitted on the recorded trajectory. ``policy_aux`` and ``reset_every``
    as in ``rollout_fn`` and ``rows_rollout_fn``; arguments of ``run``
    after the generator go to the policy, as in ``rollout_fn``."""
    return _rows_policy_rollout(env, policy, horizon, policy_aux, reset_every, graphed=False)


def _rows_policy_rollout(env, policy, horizon, policy_aux, reset_every, graphed):
    """``rows_policy_rollout_fn``. ``graphed``: the steps of every call (of
    every chunk, with ``reset_every``) are one CUDA graph, captured once and
    replayed (``_StepsGraph``); for a CUDA env whose steps draw no noise."""
    from vmas_tpu_torch.core import fused as F

    if reset_every is not None:
        chunk = _rows_policy_rollout(env, policy, reset_every, policy_aux, None, graphed)
        return _chunked_reset_rollout(env, chunk, horizon, reset_every)
    assert rows_rollout_supported(env), "rows_policy_rollout_fn: env " + _NOT_ELIGIBLE
    assert "state" not in getattr(env._fused_outputs, "unpack_reads", ()), (
        "rows_policy_rollout_fn: the policy consumes per-step obs, and this scenario's obs need per-step state "
        "reconstruction (Lidar) -- the relayout would run every step, defeating the rows structure; use "
        "rollout_fn for policy rollouts here"
    )
    assert not getattr(env._fused_outputs, "script_slots", ()), (
        "rows_policy_rollout_fn: precomputed scripted-agent actions are only wired into the random-action rows "
        "path; use rollout_fn"
    )
    world, fo, agents = env.world, env._fused_outputs, env.agents
    A, B = len(agents), env.num_envs
    step = F.make_rows_step(world, fo, [a.index for a in agents])
    n_tot = int(fo.n_out) + int(fo.n_ctrl_out)
    decoders = [_decoder(env, a) for a in agents]
    reads_c = "c" in getattr(fo, "unpack_reads", ())
    reads_u = "u" in getattr(fo, "unpack_reads", ())
    noisy = _noisy(env)
    assert not (graphed and noisy), "a noisy env's steps set the scenario's observation seed from the host"
    transform = getattr(fo, "decode_transform", None)

    def steps_of(state, obs, carry, g_pol, args, seeds=None, noise=None):
        """The horizon's steps from the observations ``obs`` and the carry
        -> (carry', extras [T, n_tot, B], the policy's aux stacked over T or
        None, each agent's decoded actions [A, T or 1, B, 2], the last
        step's comm actions, the per-step comm state or None)."""
        extras = torch.empty((horizon, n_tot, B), dtype=torch.float32, device=env.device)
        auxs, c_ts, u_ts = [], [], []
        for t in range(horizon):
            with span("vmas.rows.policy_step"):
                if policy_aux:
                    actions, aux = policy(*args, obs, g_pol)
                    auxs.append(aux)
                else:
                    actions = policy(*args, obs, g_pol)
                dec = [d(a[None]) for d, a in zip(decoders, actions)]
                us_t = [du[0] for du, _ in dec]
                ucs = [None if uc is None else uc[0] for _, uc in dec]
                if noisy:
                    at_t = lambda x: None if x is None else x[t]
                    us_t, ucs = zip(*(env._add_noise(a, u, uc, (at_t(nu), at_t(nc)))
                                      for a, u, uc, (nu, nc) in zip(agents, us_t, ucs, noise)))
                    env.scenario.obs_seed = seeds[t]
                if transform is not None:
                    us_t = transform(us_t)
                u = torch.stack(list(us_t))  # [A, B, 2]
                # the action rows: x of every agent, then y (with one agent
                # the reshape is a strided view, and the kernel reads rows)
                carry, _ = step(carry, u.permute(2, 0, 1).reshape(2 * A, B).contiguous(), extras[t])
                # the policy at t+1 acts on the observations this step
                # emitted, with this step's comm state and actions where
                # unpack reads them
                if reads_u:
                    u_ts.append(u)
                if reads_c:
                    c_ts.append(_comm_state(state, agents, ucs))
                obs = fo.unpack(extras[t], _unpack_state(env, state, list(u),
                                                         c_ts[-1] if reads_c else None))[0]
        # each agent's decoded actions [T, B, 2] where unpack reads them,
        # else its last step's as a T axis of one
        u_t = torch.stack(u_ts, dim=1) if reads_u else u[:, None]
        return (carry, extras, _stack_tree(auxs) if policy_aux else None, u_t, ucs,
                torch.stack(c_ts) if reads_c else None)

    graph = _StepsGraph(steps_of) if graphed else None

    def run(state, steps, generator, *args):
        with span("vmas.rows.call", device=env.device):
            g_pol, g_step = _fork(generator, 2)
            seeds = noise = None
            if noisy:
                seeds, noise = env._step_draws(g_step, horizon)
            with torch.no_grad():
                obs0 = env._observations(state)
                carry = F.pack_carry(world, state, fo)
                with span("vmas.rows.loop", device=env.device):
                    if graph is None:
                        carry, extras, aux, u_t, ucs, c_t = steps_of(state, obs0, carry, g_pol, args, seeds, noise)
                    else:
                        carry, extras, aux, u_t, ucs, c_t = graph(state, obs0, carry, g_pol, args)
                out = _finish_rows_rollout(env, state, steps, carry, extras, list(u_t), horizon, ucs, c_t, seeds)
            if policy_aux:
                out[2]["policy_aux"] = aux
                out[2]["obs0"] = obs0
            return out

    return run


def _tensors(tree):
    """The tensors of a tree (a ``WorldState``, tuples, dicts), in
    ``tree_leaves``' order."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _graph_key(inputs, model):
    """What a captured graph of the steps holds beyond its static inputs'
    values: the model's type and the addresses of its parameters and
    buffers, and the static inputs' shapes, dtypes and device."""
    held = list(model.parameters()) + list(model.buffers())
    return (type(model), tuple((t.data_ptr(), t.shape, t.dtype) for t in held),
            tuple((t.shape, t.dtype, t.device) for t in _tensors(inputs)))


class _StepsGraph:
    """A rows policy rollout's steps as one CUDA graph: the policy, its
    Gaussian draw, the decode, the action rows, the kernel's launch and the
    step's ``unpack``, for every step of the horizon.

    A call whose key (``_graph_key``) differs from the graph's (the first
    call, another model, parameters moved) runs the steps eagerly for its
    own result, which also warms every lazy part of them up (the kernel's
    shared-memory opt-in and check, its pair table), then captures them
    from static copies of its state, observations and carry into a new
    graph: span ``vmas.rows.capture``, recorded in every run. A call with
    the graph's key (span ``vmas.rows.replay``) copies its state,
    observations and carry into those static inputs, sets the generator
    registered with the graph to its policy generator's state, so that the
    replay draws what the eager steps draw (the same Philox seed and
    offsets), replays, and returns clones of the outputs: nothing a call
    returns aliases the graph's memory. The graph reads the parameters by
    address, so an optimizer's in-place steps show in the next replay. The
    policy takes one argument, ``make_ppo_update``'s model. The capture and
    each replay run under the carry's device, on a stream of that device,
    so an env on a card other than the current one is captured there."""

    def __init__(self, steps_of):
        self.steps_of = steps_of
        self.key = self.graph = self.inputs = self.outputs = self.generator = None
        self.launches = 0

    def __call__(self, state, obs, carry, g_pol, args):
        from vmas_tpu_torch.core import fused as F

        model, = args
        key = _graph_key((state, obs, carry), model)
        if key != self.key:
            with span("vmas.rows.capture", always=True):
                out = self.steps_of(state, obs, carry, g_pol, args)
                self._capture((state, obs, carry), args)
                self.key = key
            return out
        with span("vmas.rows.replay"), torch.cuda.device(carry.device):
            torch._foreach_copy_(self.inputs, _tensors((state, obs, carry)))
            self.generator.set_state(g_pol.get_state())
            self.graph.replay()
            F.rows_step_launches += self.launches
            return _map_tree(lambda t: t if t is None else t.clone(), self.outputs)

    def _capture(self, inputs, args):
        from vmas_tpu_torch.core import fused as F

        # the old graph's memory goes before the new one's is taken
        self.key = self.graph = self.inputs = self.outputs = None
        static = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, inputs)
        dev = static[2].device
        # under the device: registering the generator puts the graph's seed
        # and offset on the current device
        with torch.cuda.device(dev):
            self.generator = torch.Generator(device=dev)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            launches = F.rows_step_launches
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(device=dev)):
                self.outputs = self.steps_of(*static, self.generator, args)
        # the capture ran no launch: each replay counts the graph's
        self.launches, F.rows_step_launches = F.rows_step_launches - launches, launches
        self.graph, self.inputs = graph, _tensors(static)
