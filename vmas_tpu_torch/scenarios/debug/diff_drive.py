"""Differential drive (debug): one agent on DiffDrive dynamics (RK4) and
the others on HolonomicWithRotation, spawned at random; zero reward,
position and velocity observed.

Counterpart of vmas_tpu/scenarios/debug/diff_drive.py. It has no fused
outputs: with ``fused_physics=True`` the fused step runs its physics with no
emit (the torque rows of both models), and the hooks run around it.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.core import Agent, World
from vmas_tpu_torch.dynamics import DiffDrive, HolonomicWithRotation
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.plot_grid = True
        self.n_agents = kwargs.pop("n_agents", 2)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device, substeps=10)
        for i in range(self.n_agents):
            if i == 0:
                agent = Agent(name=f"diff_drive_{i}", collide=True, render_action=True, u_range=[1, 1],
                              u_multiplier=[1, 1], dynamics=DiffDrive(world, integration="rk4"))
            else:
                agent = Agent(name=f"holo_rot_{i}", collide=True, render_action=True, u_range=[1, 1, 1],
                              u_multiplier=[1, 1, 0.001], dynamics=HolonomicWithRotation())
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
