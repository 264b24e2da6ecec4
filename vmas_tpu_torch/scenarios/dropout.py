"""Dropout: any agent reaching the shared goal earns the team reward once;
actions cost energy, so the team should let its redundant movers "drop
out".

Counterpart of vmas_tpu/scenarios/dropout.py. Its outputs come out of the
fused step as rows (``DropoutOutputs``): the goal-eaten test runs in the
kernel, and the energy term is computed in ``unpack`` from the actions
(``unpack_reads = ("u",)``, which the rows rollouts hand it per step).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils

DEFAULT_ENERGY_COEFF = 0.02


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 4)
        self.energy_coeff = kwargs.pop("energy_coeff", DEFAULT_ENERGY_COEFF)
        self.start_same_point = kwargs.pop("start_same_point", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        self.agent_radius = 0.05
        self.goal_radius = 0.03

        world = World(batch_dim, device)
        for i in range(n_agents):
            world.add_agent(Agent(name=f"agent_{i}", collide=False, shape=Sphere(radius=self.agent_radius)))
        self.goal = Landmark(name="goal", collide=False, shape=Sphere(radius=self.goal_radius), color=Color.GREEN)
        world.add_landmark(self.goal)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        min_dist = self.goal_radius + self.agent_radius + 0.01
        if self.start_same_point:
            for agent in self.world.agents:
                state = agent.set_pos(state, torch.zeros((B, 2), dtype=torch.float32, device=dev))
            state = ScenarioUtils.spawn_entities_randomly(
                self.world.landmarks, self.world, state, generator, min_dist_between_entities=min_dist,
                x_bounds=(-1, 1), y_bounds=(-1, 1),
                occupied_positions=torch.zeros((B, 1, 2), dtype=torch.float32, device=dev),
            )
        else:
            state = ScenarioUtils.spawn_entities_randomly(
                self.world.policy_agents + self.world.landmarks, self.world, state, generator,
                min_dist_between_entities=min_dist, x_bounds=(-1, 1), y_bounds=(-1, 1),
            )
        state = self.goal.set_rendering(state, True)
        scratch = dict(state.scenario)
        for key in ("eaten", "done", "any_eaten"):
            scratch[key] = torch.zeros((B,), dtype=torch.bool, device=dev)
        for key in ("pos_rew", "energy_rew"):
            scratch[key] = torch.zeros((B,), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        gpos = self.goal.pos(state)
        any_eaten = torch.any(torch.stack(
            [safe_norm(a.pos(state) - gpos) < a.shape.radius + self.goal.shape.radius for a in self.world.agents],
            dim=1,
        ), dim=-1)
        scratch["any_eaten"] = any_eaten
        scratch["done"] = any_eaten
        scratch["pos_rew"] = torch.where(any_eaten & ~scratch["eaten"], 1.0, 0.0)
        scratch["energy_rew"] = energy_rew(self.world.agents, state, energy_denoms(self.world, self.world.agents),
                                           self.energy_coeff)
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["pos_rew"] + state.scenario["energy_rew"]

    def post_rewards(self, state):
        scratch = dict(state.scenario)
        eaten = scratch["eaten"] | scratch["any_eaten"]
        scratch["eaten"] = eaten
        rendering = state.rendering.clone()
        rendering[:, self.goal.index] = ~eaten
        return state.replace(scenario=scratch, rendering=rendering)

    def observation(self, agent, state):
        return torch.cat(
            [
                agent.pos(state),
                agent.vel(state),
                self.goal.pos(state) - agent.pos(state),
                state.scenario["eaten"].to(torch.float32)[:, None],
            ],
            dim=-1,
        )

    def info(self, agent, state):
        return {"pos_rew": state.scenario["pos_rew"], "energy_rew": state.scenario["energy_rew"]}

    def done(self, state):
        return state.scenario["done"]

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return DropoutOutputs(self, world)


def energy_denoms(world, agents):
    """Per agent the norm of its largest action, sqrt(dim_p * (u_range *
    u_multiplier)^2), in double precision as the JAX package takes it."""
    return [math.sqrt(world.dim_p * float((a.u_range_array[0] * a.u_multiplier_array[0]) ** 2)) for a in agents]


# each denominator as a 0-d tensor of the actions' device and dtype, made
# once: ``F._div`` copies its float from the host at every call, which a
# CUDA graph's capture refuses
_DENOMS = {}


def energy_rew(agents, state, denoms, coeff):
    """``coeff * -sum_a |u_a| / denom_a`` over the agents' actions (any
    leading axes), summed in agent order from the first term; each quotient
    one IEEE division (``F._div``'s, by a denominator kept on the device)."""
    total = None
    for a, d in zip(agents, denoms):
        n = safe_norm(a.u(state))
        key = (d, n.device, n.dtype)
        if key not in _DENOMS:
            _DENOMS[key] = n.new_tensor(d)
        t = n / _DENOMS[key]
        total = t if total is None else total + t
    return coeff * -total


class DropoutOutputs(F.FusedOutputs):
    """Dropout's observations, goal reward and done as extra rows of the
    fused step (the plain version; the kernel's DropoutEmit). The
    observation's eaten flag is the merged one, as the hook pipeline reads
    it after post_rewards; post_rewards (the goal's rendering) still runs
    on the unpacked state, and once on a rows rollout's final state
    (``post_rewards_rollout_safe``).

    Rows: per agent pos, vel, goal - agent (6); then eaten (merged),
    any_eaten and the goal reward. Scratch in: eaten."""

    agent_w = 6
    n_scratch_in = 1  # the previous eaten
    unpack_reads = ("u",)
    post_rewards_rollout_safe = True

    def __init__(self, scenario, world):
        self.agents = world.policy_agents
        self.agent_i = [a.index for a in self.agents]
        self.n_agents = A = len(self.agent_i)
        self.goal_i = scenario.goal.index
        # each agent's eating range: the double sum of the two radii the JAX
        # package compares against, rounded once to f32
        self.eat_r = [float(np.float32(float(a.shape.radius) + float(scenario.goal.shape.radius)))
                      for a in self.agents]
        self.denoms = energy_denoms(world, self.agents)
        self.coeff = float(scenario.energy_coeff)
        self.base = A * self.agent_w
        self.n_out = self.base + 3
        # rows-carried rollout: the next step's eaten is this step's merged
        # eaten row
        self.carry_extra_idx = (self.base,)
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["eaten"].to(torch.float32)[None]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        eaten_prev = ctx["scratch"][0] > 0.5
        gx, gy = px[self.goal_i], py[self.goal_i]
        rows, any_eaten = [], None
        for ai, r in zip(self.agent_i, self.eat_r):
            hit = F._norm(px[ai] - gx, py[ai] - gy) < r
            any_eaten = hit if any_eaten is None else (any_eaten | hit)
            rows += [px[ai], py[ai], vx[ai], vy[ai], gx - px[ai], gy - py[ai]]
        pos_rew = torch.where(any_eaten & ~eaten_prev, 1.0, 0.0)
        rows += [(eaten_prev | any_eaten).to(torch.float32), any_eaten.to(torch.float32), pos_rew]
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through, and then the
        agents' u in ``state`` carry it too (the rows rollouts' per-step
        actions)."""
        A, w, base = self.n_agents, self.agent_w, self.base
        # slices, not an index list: a list is copied from the host at every
        # call, which a CUDA graph's capture refuses
        obs = tuple(torch.cat([extra[..., i * w:(i + 1) * w, :], extra[..., base:base + 1, :]], dim=-2)
                    .transpose(-1, -2) for i in range(A))
        eaten = extra[..., base, :] > 0.5
        any_eaten = extra[..., base + 1, :] > 0.5
        pos_rew = extra[..., base + 2, :]
        en = energy_rew(self.agents, state, self.denoms, self.coeff)
        rew = pos_rew + en
        updates = {"eaten": eaten, "any_eaten": any_eaten, "done": any_eaten, "pos_rew": pos_rew,
                   "energy_rew": en}
        return obs, tuple(rew for _ in range(A)), any_eaten, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            ep = K.EmitParams()
            ep.carry_idx[0] = self.carry_extra_idx[0]
            p = ep.dropout
            p.n_agents, p.goal = self.n_agents, self.goal_i
            for i, ai in enumerate(self.agent_i):
                p.agent[i], p.eat_r[i] = ai, self.eat_r[i]
            self._kernel_emit = (K.EMIT_DROPOUT, ep)
        return self._kernel_emit
