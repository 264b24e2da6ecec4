"""Circle trajectory (debug): one agent on a PID velocity controller is
rewarded for keeping to a circle of radius 1.5 and for its speed along the
circle's tangent; its velocity commands are clamped to ``u_range``, zeroed
below ``min_input_norm`` and optionally delayed by ``dt_delay`` steps.

Counterpart of vmas_tpu/scenarios/debug/circle_trajectory.py. The commands
are clamped on ``sqrt(x*x + y*y)`` (``fused.clamp_with_row_norm``), as the
velocity-controlled worlds of the port clamp. It has no fused outputs: with
``fused_physics=True`` the fused step runs its physics with no emit, and the
hooks run around it.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.controllers import VelocityController
from vmas_tpu_torch.core import Agent, Sphere, World
from vmas_tpu_torch.core.utils import TorchUtils, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.debug.goal import clamp_command, delayed
from vmas_tpu_torch.utils import ScenarioUtils


def normalized(v):
    """``v / |v|``, zero where ``|v|`` is zero."""
    n = safe_norm(v)[:, None]
    return torch.where(n == 0, 0.0, v / torch.where(n == 0, 1.0, n))


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.u_range = kwargs.pop("u_range", 1)
        self.a_range = kwargs.pop("a_range", 1)
        self.obs_noise = kwargs.pop("obs_noise", 0.0)
        self.dt_delay = kwargs.pop("dt_delay", 0)
        self.min_input_norm = kwargs.pop("min_input_norm", 0.08)
        self.linear_friction = kwargs.pop("linear_friction", 0.1)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.agent_radius = 0.16
        self.desired_radius = 1.5
        self.viewer_zoom = 2
        self.f_range = self.a_range + self.linear_friction

        world = World(batch_dim, device, linear_friction=self.linear_friction, dt=0.05, drag=0)
        self.agent = Agent(name="agent_0", shape=Sphere(self.agent_radius), f_range=self.f_range,
                           u_range=self.u_range, render_action=True)
        world.add_agent(self.agent)
        self.controller = VelocityController(self.agent, world, [2, 6, 0.002], "standard")
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        state = self.controller.reset(state)
        pos = (torch.rand((B, 2), generator=generator, device=dev) * 2 - 1) * self.desired_radius
        state = self.agent.set_pos(state, pos)
        if self.dt_delay > 0:
            scratch = dict(state.scenario)
            scratch["queue"] = torch.zeros((self.dt_delay, B, 2), dtype=torch.float32, device=dev)
            state = state.replace(scenario=scratch)
        return state

    def process_action(self, agent, state):
        u = agent.u(state)
        if self.dt_delay > 0:
            state, u = delayed(state, "queue", u)
        state = agent.set_u(state, clamp_command(u, self.u_range, self.min_input_norm))
        return self.controller.process_force(state)

    def _closest_point_circle(self, state, agent):
        return normalized(agent.pos(state)) * self.desired_radius

    def _tangent_to_circle(self, state, agent, closest_point):
        pos = agent.pos(state)
        d = pos - closest_point
        inside = safe_norm(pos) < self.desired_radius
        angle90 = torch.full((pos.shape[0],), math.pi / 2, dtype=torch.float32, device=pos.device)
        rot90 = TorchUtils.rotate_vector(d, angle90)
        rot_neg90 = TorchUtils.rotate_vector(d, -angle90)
        return normalized(torch.where(inside[:, None], rot_neg90, rot90))

    def reward(self, agent, state):
        closest = self._closest_point_circle(state, agent)
        pos_rew = -(safe_norm(agent.pos(state) - closest) ** 0.5)
        tangent = self._tangent_to_circle(state, agent, closest)
        dot = torch.sum(tangent * agent.vel(state), dim=-1) * 0.5
        return pos_rew + dot

    def observation(self, agent, state):
        return torch.cat([agent.pos(state), agent.vel(state), agent.pos(state)], dim=-1)

    def extra_render(self, env, ax, env_index: int = 0):
        """The trajectory's goal circle and the tangent-velocity line."""
        from vmas_tpu_torch.render import draw

        draw.draw_circle(ax, (0.0, 0.0), self.desired_radius, (0, 0, 0))
        agent = self.world.agents[0]
        closest = self._closest_point_circle(env.state, agent)
        tangent = self._tangent_to_circle(env.state, agent, closest)[env_index].numpy()
        draw.draw_line(ax, (0, 0), tangent, (0, 0, 0))
