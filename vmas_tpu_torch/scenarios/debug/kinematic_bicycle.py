"""Kinematic bicycle (debug): one box agent on KinematicBicycle dynamics
(Euler) and the others on HolonomicWithRotation, spawned at random in
stiff box-box contact (collision force 500, 10 substeps); zero reward,
position and velocity observed.

Counterpart of vmas_tpu/scenarios/debug/kinematic_bicycle.py. It has no
fused outputs: with ``fused_physics=True`` the fused step runs its physics
with no emit, and the hooks run around it.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.core import Agent, Box, World
from vmas_tpu_torch.dynamics import HolonomicWithRotation, KinematicBicycle
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 2)
        width = kwargs.pop("width", 0.1)
        l_f = kwargs.pop("l_f", 0.1)
        l_r = kwargs.pop("l_r", 0.1)
        max_steering_angle = kwargs.pop("max_steering_angle", math.radians(30.0))
        max_speed = kwargs.pop("max_speed", 1.0)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device, substeps=10, collision_force=500)
        for i in range(self.n_agents):
            if i == 0:
                agent = Agent(
                    name=f"bicycle_{i}", shape=Box(length=l_f + l_r, width=width), collide=True,
                    render_action=True, u_range=[max_speed, float(max_steering_angle)], u_multiplier=[1, 1],
                    max_speed=max_speed,
                    dynamics=KinematicBicycle(world, width=width, l_f=l_f, l_r=l_r,
                                              max_steering_angle=float(max_steering_angle), integration="euler"),
                )
            else:
                agent = Agent(name=f"holo_rot_{i}", shape=Box(length=l_f + l_r, width=width), collide=True,
                              render_action=True, u_range=[1, 1, 1], u_multiplier=[1, 1, 0.001],
                              dynamics=HolonomicWithRotation())
            world.add_agent(agent)
        return world

    def reset_world_at(self, state, generator):
        return ScenarioUtils.spawn_entities_randomly(
            self.world.agents, self.world, state, generator,
            min_dist_between_entities=0.1, x_bounds=(-1, 1), y_bounds=(-1, 1),
        )

    def reward(self, agent, state):
        return torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)

    def observation(self, agent, state):
        return torch.cat([agent.pos(state), agent.vel(state)], dim=-1)

    def extra_render(self, env, ax, env_index: int = 0):
        """Heading ticks."""
        from vmas_tpu_torch.render import draw

        for agent in self.world.agents:
            draw.plot_entity_rotation(ax, agent, env.state, env_index, length=0.1)
