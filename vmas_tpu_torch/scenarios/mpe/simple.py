"""MPE simple: one agent, one landmark; the reward is minus the squared
distance to it.

Counterpart of vmas_tpu/scenarios/mpe/simple.py. Its
outputs come out of the fused step as rows (``SimpleOutputs``); its world
has no contact pair and no joint.
"""

from __future__ import annotations

import numpy as np
import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


def uniform_positions(generator, entities, state, lo=-1.0, hi=1.0):
    """Scatter entities uniformly in [lo, hi)^2 (the MPE reset pattern),
    one draw of [B, 2] per entity in order."""
    B, dev = state.batch_dim, state.device
    for e in entities:
        pos = torch.rand((B, 2), generator=generator, device=dev) * (hi - lo) + lo
        state = e.set_pos(state, pos)
    return state


def index_run(idx, what):
    """``(first, count)`` of entity indices ``idx`` that run one after the
    other, the form in which the MPE emits' kernel parameters name them."""
    if not idx or idx != list(range(idx[0], idx[0] + len(idx))):
        raise NotImplementedError(f"the fused kernel's MPE emits take {what} of consecutive entity indices, got {idx}")
    return idx[0], len(idx)


def hit_distance(ra: float, rb: float) -> float:
    """The distance below which two spheres of radii ``ra`` and ``rb``
    touch, as the MPE emits compare it: the sum in double precision, rounded
    once to f32 (a Python float the JAX package compares an f32 row
    against)."""
    return float(np.float32(ra + rb))


def radius_classes(radii):
    """``(class of each radius, the distinct radii)``: the kernel's MPE
    emits read collision distances by pair of radius classes (at most
    ``MAX_RC`` of them)."""
    distinct = list(dict.fromkeys(float(r) for r in radii))
    if len(distinct) > K.MAX_RC:
        raise NotImplementedError(f"the fused kernel's MPE emits take at most {K.MAX_RC} distinct agent radii")
    return [distinct.index(float(r)) for r in radii], distinct


def along(x, like):
    """``x [B, w]`` expanded over the leading axes of ``like [..., B, v]``
    (a rollout's T): the constant blocks of an MPE observation."""
    return x.expand(like.shape[:-1] + x.shape[-1:])


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        ScenarioUtils.check_kwargs_consumed(kwargs)
        world = World(batch_dim, device)
        world.add_agent(Agent(name="agent_0", collide=False, color=Color.GRAY))
        world.add_landmark(Landmark(name="landmark 0", collide=False, color=Color.RED))
        return world

    def reset_world_at(self, state, generator):
        state = uniform_positions(generator, self.world.agents, state)
        return uniform_positions(generator, self.world.landmarks, state)

    def reward(self, agent, state):
        delta = agent.pos(state) - self.world.landmarks[0].pos(state)
        return -torch.sum(torch.square(delta), dim=-1)

    def observation(self, agent, state):
        entity_pos = [lm.pos(state) - agent.pos(state) for lm in self.world.landmarks]
        return torch.cat([agent.vel(state), *entity_pos], dim=-1)

    def make_fused_outputs(self, world):
        return SimpleOutputs(world)


class SimpleOutputs(F.FusedOutputs):
    """simple's observations and rewards as extra rows of the fused step: per
    agent its velocity and each landmark's pos - the agent's (``obs_w``),
    then per agent the reward, minus the squared distance to landmark 0. No
    scratch."""

    n_scratch_in = 0
    carry_extra_idx = ()  # no kernel-read scratch: rows-rollout eligible

    def __init__(self, world):
        self.agent_i = [a.index for a in world.policy_agents]
        self.lm_i = [lm.index for lm in world.landmarks]
        self.n_agents = A = len(self.agent_i)
        self.obs_w = 2 + 2 * len(self.lm_i)
        self.base = A * self.obs_w
        self.n_out = self.base + A
        self._kernel_emit = None

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rows, rews = [], []
        l0 = self.lm_i[0]
        for ai in self.agent_i:
            rows += [vx[ai], vy[ai]]
            for li in self.lm_i:
                rows += [px[li] - px[ai], py[li] - py[ai]]
            dx, dy = px[ai] - px[l0], py[ai] - py[l0]
            rews.append(-(dx * dx + dy * dy))
        return rows + rews

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, {}); a
        leading rollout axis passes through."""
        A, w = self.n_agents, self.obs_w
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        rews = tuple(extra[..., self.base + i, :] for i in range(A))
        return obs, rews, torch.zeros_like(rews[0], dtype=torch.bool), {}

    def kernel_emit(self):
        if self._kernel_emit is None:
            ep = K.EmitParams()
            p = ep.simple
            p.a0, p.n_agents = index_run(self.agent_i, "agents")
            p.l0, p.n_lm = index_run(self.lm_i, "landmarks")
            self._kernel_emit = (K.EMIT_SIMPLE, ep)
        return self._kernel_emit
