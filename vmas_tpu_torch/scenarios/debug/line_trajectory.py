"""Line trajectory (debug): one agent on a PID velocity controller is
rewarded for keeping to the line x = 0, for its speed along it and for
moving the way it is told; done once past y = 2.

Counterpart of vmas_tpu/scenarios/debug/line_trajectory.py. Its commands go
to the controller unclamped, as in the JAX package. It has no fused outputs:
with ``fused_physics=True`` the fused step runs its physics with no emit,
and the hooks run around it.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.controllers import VelocityController
from vmas_tpu_torch.core import Agent, Sphere, World
from vmas_tpu_torch.core.utils import X, Y, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.debug.circle_trajectory import normalized
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.obs_noise = kwargs.pop("obs_noise", 0)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.agent_radius = 0.03
        self.line_length = 3

        world = World(batch_dim, device, drag=0.1)
        self.agent = Agent(name="agent_0", shape=Sphere(self.agent_radius), mass=2, f_range=0.5, u_range=1,
                           render_action=True)
        world.add_agent(self.agent)
        self.controller = VelocityController(self.agent, world, [4, 1.25, 0.001], "standard")
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        state = self.controller.reset(state)
        r = torch.rand((B, 2), generator=generator, device=dev)
        pos = torch.stack([r[:, 0] * 2 - 1, r[:, 1] - 1], dim=-1)
        state = self.agent.set_pos(state, pos)
        scratch = dict(state.scenario)
        scratch["vel_action"] = torch.zeros((B, 2), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def process_action(self, agent, state):
        scratch = dict(state.scenario)
        scratch["vel_action"] = agent.u(state)
        state = state.replace(scenario=scratch)
        return self.controller.process_force(state)

    def reward(self, agent, state):
        pos = agent.pos(state)
        closest = torch.stack([torch.zeros_like(pos[:, X]), pos[:, Y]], dim=-1)
        pos_rew = -(safe_norm(pos - closest) ** 0.5)
        tangent = torch.stack([torch.zeros_like(pos[:, X]), torch.ones_like(pos[:, Y])], dim=-1)
        dot_product = torch.sum(tangent * agent.vel(state), dim=-1) * 0.5
        steady = torch.sum(normalized(agent.vel(state)) * normalized(state.scenario["vel_action"]), dim=-1) * 0.2
        return pos_rew + dot_product + steady

    def observation(self, agent, state):
        return torch.cat([agent.pos(state), agent.vel(state), agent.pos(state)], dim=-1)

    def done(self, state):
        return self.world.agents[0].pos(state)[:, Y] > self.line_length - 1

    def extra_render(self, env, ax, env_index: int = 0):
        """The trajectory's goal line."""
        from vmas_tpu_torch.render import draw

        draw.draw_line(ax, (0, -1), (0, -1 + self.line_length), (0, 0, 0))
