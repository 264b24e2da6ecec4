"""Goal (debug): one agent on a PID velocity controller seeks a goal, its
velocity commands clamped to ``u_range``, zeroed below
``min_input_norm`` and optionally delayed by ``dt_delay`` steps; shaped by
the distance to the goal, a time penalty and an energy term.

Counterpart of vmas_tpu/scenarios/debug/goal.py. The commands are clamped
on ``sqrt(x*x + y*y)`` (``fused.clamp_with_row_norm``), as the
velocity-controlled worlds of the port clamp. It has no fused outputs:
with ``fused_physics=True`` the fused step runs its physics with no emit,
and the hooks (the controller among them) run around it.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.controllers import VelocityController
from vmas_tpu_torch.core import Agent, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


def delayed(state, key, u):
    """``(state, u')``: the command of ``dt_delay`` steps ago from the FIFO
    ``state.scenario[key]`` ``[dt_delay, B, 2]``, which takes ``u`` in."""
    scratch = dict(state.scenario)
    q = scratch[key]
    scratch[key] = torch.cat([q[1:], u[None]], dim=0)
    return state.replace(scenario=scratch), q[0]


def clamp_command(u, u_range, min_input_norm):
    """The velocity command clamped to norm ``u_range`` and zeroed where its
    norm is below ``min_input_norm``."""
    u = F.clamp_with_row_norm(u, u_range)
    return torch.where((safe_norm(u) < min_input_norm)[:, None], 0.0, u)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.u_range = kwargs.pop("u_range", 1)
        self.a_range = kwargs.pop("a_range", 1)
        self.obs_noise = kwargs.pop("obs_noise", 0.0)
        self.dt_delay = kwargs.pop("dt_delay", 0)
        self.min_input_norm = kwargs.pop("min_input_norm", 0.08)
        self.linear_friction = kwargs.pop("linear_friction", 0.1)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1.0)
        self.time_rew_coeff = kwargs.pop("time_rew_coeff", -0.01)
        self.energy_reward_coeff = kwargs.pop("energy_rew_coeff", 0.0)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.viewer_size = (1600, 700)
        self.viewer_zoom = 2
        self.plot_grid = True
        self.agent_radius = 0.16
        self.lab_length = 6
        self.lab_width = 3
        self.f_range = self.a_range + self.linear_friction

        world = World(batch_dim, device, drag=0, dt=0.05, substeps=5)
        self.goal = Landmark("goal", collide=False, movable=False, shape=Sphere(radius=0.06))
        world.add_landmark(self.goal)
        agent = Agent(name="agent 0", collide=True, color=Color.GREEN, render_action=True,
                      linear_friction=self.linear_friction, shape=Sphere(radius=self.agent_radius),
                      f_range=self.f_range, u_range=self.u_range)
        agent.goal = self.goal
        world.add_agent(agent)
        self.controller = VelocityController(agent, world, [2, 6, 0.002], "standard")
        return world

    def _goal_dist(self, state):
        return torch.min(torch.stack([safe_norm(self.goal.pos(state) - a.pos(state)) for a in self.world.agents],
                                     dim=1), dim=1).values

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        state = self.controller.reset(state)

        def rand_pos():
            half = torch.tensor([self.lab_length / 2, self.lab_width / 2], dtype=torch.float32, device=dev)
            return (torch.rand((B, 2), generator=generator, device=dev) * 2 - 1) * half

        pos = rand_pos()
        for agent in self.world.agents:
            state = agent.set_pos(state, pos)
        state = self.goal.set_pos(state, rand_pos())

        scratch = dict(state.scenario)
        scratch["pos_shaping"] = self._goal_dist(state) * self.pos_shaping_factor
        scratch["pos_rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch["time_rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        if self.dt_delay > 0:
            scratch["queue"] = torch.zeros((self.dt_delay, B, 2), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def process_action(self, agent, state):
        u = agent.u(state)
        if self.dt_delay > 0:
            state, u = delayed(state, "queue", u)
        state = agent.set_u(state, clamp_command(u, self.u_range, self.min_input_norm))
        return self.controller.process_force(state)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        goal_dist = self._goal_dist(state)
        goal_reached = goal_dist < self.goal.shape.radius
        pos_shaping = goal_dist * self.pos_shaping_factor
        scratch["pos_rew"] = torch.where(~goal_reached, scratch["pos_shaping"] - pos_shaping, 0.0)
        scratch["pos_shaping"] = pos_shaping
        scratch["time_rew"] = torch.where(~goal_reached, self.time_rew_coeff, 0.0)
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        norm = math.sqrt(self.world.dim_p * (self.f_range**2))
        energy = torch.stack([safe_norm(a.u(state)) / norm for a in self.world.agents], dim=1).sum(-1)
        return s["pos_rew"] + -energy * self.energy_reward_coeff + s["time_rew"]

    def observation(self, agent, state):
        return torch.cat([agent.pos(state), agent.vel(state), agent.pos(state) - self.goal.pos(state)], dim=-1)

    def info(self, agent, state):
        return {"pos_rew": state.scenario["pos_rew"], "time_rew": state.scenario["time_rew"]}
