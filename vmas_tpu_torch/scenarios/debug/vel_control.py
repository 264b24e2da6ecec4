"""Velocity control (debug): three agents track velocity commands through
PID velocity controllers: the green one of mass ``green_mass``, a blue one
whose x command is limited to an acceleration of 1, and a blue one with a
force range of 30; rewarded by minus their energy.

Counterpart of vmas_tpu/scenarios/debug/vel_control.py. The commands are
clamped on ``sqrt(x*x + y*y)`` (``fused.clamp_with_row_norm``), as the
velocity-controlled worlds of the port clamp. It has no fused outputs:
with ``fused_physics=True`` the fused step runs its physics with no emit,
and the hooks (the controllers among them) run around it.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.controllers import VelocityController
from vmas_tpu_torch.core import Agent, Color, Landmark, World
from vmas_tpu_torch.core.fused import _div
from vmas_tpu_torch.core.utils import X, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.debug.goal import clamp_command
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.green_mass = kwargs.pop("green_mass", 1)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        self.plot_grid = True
        self.agent_radius = 0.16

        controller_params = [2, 6, 0.002]
        linear_friction = 0.1
        v_range = 1
        a_range = 1
        f_range = linear_friction + a_range
        u_range = v_range

        world = World(batch_dim, device, linear_friction=linear_friction, drag=0, dt=0.05, substeps=4)

        self.controllers = {}
        specs = [
            dict(name="agent 0", color=Color.GREEN, mass=self.green_mass, f_range=f_range),
            dict(name="agent 1", color=Color.BLUE, mass=1.0, f_range=None),
            dict(name="agent 2", color=Color.BLUE, mass=1.0, f_range=30),
        ]
        for s in specs:
            agent = Agent(name=s["name"], collide=False, color=s["color"], render_action=True, mass=s["mass"],
                          f_range=s["f_range"], u_range=u_range)
            world.add_agent(agent)
            self.controllers[agent.name] = VelocityController(agent, world, controller_params, "standard")

        self.landmark = Landmark("landmark 0", collide=False, movable=True)
        world.add_landmark(self.landmark)
        self.u_range = u_range
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        start = torch.tensor([-1.0, 0.0], dtype=torch.float32, device=dev).expand(B, 2)
        for agent in self.world.agents:
            state = self.controllers[agent.name].reset(state)
            state = agent.set_pos(state, start)
        scratch = dict(state.scenario)
        scratch["energy_expenditure"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def process_action(self, agent, state):
        u = clamp_command(agent.u(state), self.u_range, 0.08)
        if agent is self.world.agents[1]:
            max_a = 1.0
            vel_x = agent.vel(state)[:, X]
            requested_a = _div(u[:, X] - vel_x, self.world.dt)
            achievable_a = torch.clamp(requested_a, -max_a, max_a)
            u = torch.stack([achievable_a * self.world.dt + vel_x, u[:, 1]], dim=-1)
        state = agent.set_u(state, u)
        return self.controllers[agent.name].process_force(state)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        scratch["energy_expenditure"] = (
            -torch.stack([safe_norm(a.u(state)) for a in self.world.agents], dim=1).sum(-1) * 3
        )
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["energy_expenditure"]

    def observation(self, agent, state):
        return torch.cat([agent.pos(state), agent.vel(state)], dim=-1)

    def info(self, agent, state):
        return {"energy_expenditure": state.scenario["energy_expenditure"]}
