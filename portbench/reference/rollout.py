"""Plain reference rollouts over a configuration's rows step: random actions
(the ``rollout`` traffic) and a Gaussian policy (the ``ppo`` traffic's
collection).

The benchmark hands both sides a ``torch.Generator`` seeded from ``--seed``;
the program forks two generators from it per call and draws its actions
from the first. :func:`fork` works the same seeds out again (a hash of the
caller's generator state, which then advances by one draw), so the reference
draws the same actions from the same seed without reading anything the
program made.
"""

from __future__ import annotations

import hashlib
import sys

import torch

from portbench.reference.physics import rows_step


def draw_seed(generator):
    """A 64-bit seed from ``generator``'s state, which then advances by one
    draw on its device."""
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes(), digest_size=8).digest()
    torch.empty((1,), device=generator.device).random_(generator=generator)
    return int.from_bytes(digest, "little")


def fork(generator, n):
    """``n`` generators on ``generator``'s device, each seeded by
    :func:`draw_seed`."""
    out = []
    for _ in range(n):
        g = torch.Generator(device=generator.device)
        g.manual_seed(draw_seed(generator))
        out.append(g)
    return out


def random_actions(cfg, generator, horizon, B, device):
    """The action rows [T, 2A, B] of uniform random actions: per agent
    ``(U(0, 1) * 2 - 1) * u_range`` over the horizon (u_range 1), times the
    agent's u_multiplier; x of every agent, then y."""
    A = len(cfg.ACT_SLOTS)
    ones = torch.ones((2,), device=device)
    mult = torch.full((2,), cfg.U_MULTIPLIER, dtype=torch.float32, device=device)
    us = [((torch.rand((horizon, B, 2), generator=generator, device=device) * 2 - 1) * ones) * mult
          for _ in range(A)]
    ax = torch.stack([u[..., 0] for u in us], dim=1)
    ay = torch.stack([u[..., 1] for u in us], dim=1)
    return torch.cat([ax, ay], dim=1).contiguous()


def random_rollout(cfg, spec, carry, generator, horizon):
    """``horizon`` steps with random actions from the rows ``carry`` ->
    (final carry, emit rows [T, n_out, B]), in ``spec.dtype``. On a GPU one
    step is captured once in a CUDA graph and replayed, which runs the same
    kernels as the eager step without its host cost per operation."""
    B = carry.shape[1]
    g_act, _ = fork(generator, 2)
    act = random_actions(cfg, g_act, horizon, B, carry.device).to(spec.dtype)
    carry = carry.to(spec.dtype)

    def step(c, a):
        return rows_step(spec, cfg.emit, cfg.CARRY_EXTRA_IDX, cfg.ACT_SLOTS, c, a)

    if carry.device.type == "cuda":
        graphed = _graph(step, carry, act[0])
        if graphed is not None:
            g, c_in, a_in, c_out, e_out = graphed
            extras = torch.empty((horizon,) + tuple(e_out.shape), dtype=e_out.dtype, device=carry.device)
            for t in range(horizon):
                a_in.copy_(act[t])
                g.replay()
                extras[t].copy_(e_out)
                c_in.copy_(c_out)
            return c_in.clone(), extras
    extras = []
    for t in range(horizon):
        carry, extra = step(carry, act[t])
        extras.append(extra)
    return carry, torch.stack(extras)


def _graph(step, carry, act):
    """``step(carry, act)`` captured in a CUDA graph on static copies of its
    inputs -> (graph, carry in, act in, carry out, extra out), or None where
    the capture fails (the caller then steps eagerly)."""
    c_in, a_in = carry.clone(), act.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(c_in, a_in)  # makes the step's constants before the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            c_out, e_out = step(c_in, a_in)
    except RuntimeError as err:
        print(f"the reference steps eagerly: its CUDA graph capture failed ({err})", file=sys.stderr, flush=True)
        return None
    return g, c_in, a_in, c_out, e_out


def policy_rollout(cfg, spec, policy, carry, obs0, generator, horizon):
    """``horizon`` steps of ``policy(obs_tuple, generator) -> (actions_tuple,
    aux)`` from the rows ``carry``, the policy acting on ``obs0`` first and
    then on each step's emitted observations -> (final carry, emit rows [T,
    n_out, B], the stacked aux)."""
    g_pol, _ = fork(generator, 2)
    A = len(cfg.ACT_SLOTS)
    mult = torch.full((2,), cfg.U_MULTIPLIER, dtype=torch.float32, device=carry.device)
    carry = carry.to(spec.dtype)
    obs, extras, auxs = obs0, [], []
    for _ in range(horizon):
        actions, aux = policy(obs, g_pol)
        auxs.append(aux)
        u = torch.stack([a.to(torch.float32)[..., :2] * mult for a in actions])  # [A, B, 2]
        carry, extra = rows_step(spec, cfg.emit, cfg.CARRY_EXTRA_IDX, cfg.ACT_SLOTS, carry,
                                 u.permute(2, 0, 1).reshape(2 * A, -1).to(spec.dtype))
        extras.append(extra)
        obs = tuple(o.to(torch.float32) for o in cfg.unpack(extra)[0])
    stacked = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
    return carry, torch.stack(extras), stacked
