"""Drone (debug): agents on Drone dynamics (RK4) with torque-only control:
the scenario's process_action prepends the hover thrust, so the step's
hooks see a ``[B, 4]`` u, and the state that leaves the step carries the
spawn-time ``[B, 3]`` (``Environment._canonical_u``). An env is done once
any drone rolls or pitches beyond 30 degrees (``Drone.needs_reset``).

Counterpart of vmas_tpu/scenarios/debug/drone.py. It has no fused outputs:
with ``fused_physics=True`` the fused step runs its physics with no emit,
and the hooks run around it.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.core import Agent, World
from vmas_tpu_torch.dynamics import Drone
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.plot_grid = True
        self.n_agents = kwargs.pop("n_agents", 2)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device, substeps=10)
        for i in range(self.n_agents):
            world.add_agent(
                Agent(name=f"drone_{i}", collide=True, render_action=True, u_range=[0.00001, 0.00001, 0.00001],
                      u_multiplier=[1, 1, 1], action_size=3, dynamics=Drone(world, integration="rk4"))
            )
        return world

    def reset_world_at(self, state, generator):
        return ScenarioUtils.spawn_entities_randomly(
            self.world.agents, self.world, state, generator,
            min_dist_between_entities=0.1, x_bounds=(-1, 1), y_bounds=(-1, 1),
        )

    def process_action(self, agent, state):
        torque = agent.u(state)
        thrust = torch.full((state.batch_dim, 1), agent.mass * agent.dynamics.g, dtype=torch.float32,
                            device=state.device)
        return agent.set_u(state, torch.cat([thrust, torque], dim=-1))

    def reward(self, agent, state):
        return torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)

    def observation(self, agent, state):
        return torch.cat([agent.pos(state), agent.vel(state)], dim=-1)

    def done(self, state):
        return torch.any(torch.stack([a.dynamics.needs_reset(state) for a in self.world.agents], dim=-1), dim=-1)

    def extra_render(self, env, ax, env_index: int = 0):
        """Heading ticks."""
        from vmas_tpu_torch.render import draw

        for agent in self.world.agents:
            draw.plot_entity_rotation(ax, agent, env.state, env_index, length=0.1)
