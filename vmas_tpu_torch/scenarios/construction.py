"""Construction: agents in the DOTS arena with collection points and
blueprints (a scaffold: its rewards are zeros, as the reference's are).

Counterpart of vmas_tpu/scenarios/construction.py. Every blueprint is named
"blueprint", as in the reference, so an entity is known by its position in
the world's lists, never by its name. No fused outputs: with
``fused_physics=True`` the fused step runs with no emit.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.core import Box, Color, Landmark, Sphere
from vmas_tpu_torch.dots_core import DOTSAgent, DOTSWorld
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.get("n_agents", 4)
        self.agent_radius = 0.2
        assert self.n_agents > 1
        assert self.n_agents % 2 == 0, "This scenario requires an even number of agents."

        self.arena_size = 5
        self.viewer_zoom = 1.7
        self.n_collection_points = kwargs.get("n_collection_points", 1)
        self.col_point_size = self.agent_radius * 2.2
        assert self.n_collection_points >= 1
        self.n_blueprints = kwargs.get("n_blueprints", math.floor(self.n_agents / 2))
        assert self.n_blueprints > 0

        world = DOTSWorld(batch_dim, device, collision_force=400, substeps=5)
        for i in range(self.n_agents):
            world.add_agent(DOTSAgent(name=f"agent_{i}", shape=Sphere(self.agent_radius), u_multiplier=0.7,
                                      color=Color.GREEN))
        self.col_points = []
        for i in range(self.n_collection_points):
            cp = Landmark(name=f"collection_point_{i}", collide=False,
                          shape=Box(length=self.col_point_size, width=self.col_point_size), color=Color.RED)
            self.col_points.append(cp)
            world.add_landmark(cp)
        self.blueprints = []
        for _ in range(self.n_blueprints):
            bp = Landmark(name="blueprint", collide=False,
                          shape=Box(length=self.col_point_size, width=self.col_point_size * 2), color=Color.BLUE)
            self.blueprints.append(bp)
            world.add_landmark(bp)
        world.spawn_map()
        return world

    def reset_world_at(self, state, generator):
        state = self.world.reset_map(state)
        return ScenarioUtils.spawn_entities_randomly(
            self.world.agents + self.col_points + self.blueprints, self.world, state, generator,
            min_dist_between_entities=1,
            x_bounds=(int(-self.arena_size / 2), int(self.arena_size / 2)),
            y_bounds=(int(-self.arena_size / 2), int(self.arena_size / 2)),
        )

    def observation(self, agent, state):
        col_point_dists = torch.cat([p.pos(state) - agent.pos(state) for p in self.col_points], dim=-1)
        blueprint_dists = torch.cat([bp.pos(state) - agent.pos(state) for bp in self.blueprints], dim=-1)
        return torch.cat([agent.pos(state), agent.vel(state), col_point_dists, blueprint_dists], dim=-1)

    def reward(self, agent, state):
        return torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)

    def done(self, state):
        return torch.zeros((state.batch_dim,), dtype=torch.bool, device=state.device)

    def info(self, agent, state):
        z = torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)
        return {"pos_rew": z, "ground_rew": z}
