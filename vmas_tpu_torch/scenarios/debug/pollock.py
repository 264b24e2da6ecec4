"""Pollock (debug): a dense soup of spheres, lines and boxes, the test bed of
the Lidar.

Counterpart of vmas_tpu/scenarios/debug/pollock.py. With ``lidar=True``
each agent observes a 16-ray Lidar; ``vectorized_lidar`` switches between
the batched cast of all rays and the per-ray loop, which must agree. Its 45
entities make some 900 contact pairs, beyond the fused step's cost rule
(``fused.supports`` refuses the world, as the JAX package's does), so it
runs on the plain physics.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.core import Agent, Box, Color, Landmark, Line, Sphere, World
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.sensors import Lidar
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 15)
        self.n_lines = kwargs.pop("n_lines", 15)
        self.n_boxes = kwargs.pop("n_boxes", 15)
        self.lidar = kwargs.pop("lidar", False)
        self.vectorized_lidar = kwargs.pop("vectorized_lidar", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.agent_radius = 0.05
        self.line_length = 0.3
        self.box_length = 0.2
        self.box_width = 0.1
        self.world_semidim = 1
        self.min_dist_between_entities = 0.1

        world = World(
            batch_dim, device, dt=0.1, drag=0.25, substeps=5, collision_force=500,
            x_semidim=self.world_semidim, y_semidim=self.world_semidim,
        )
        for i in range(self.n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}", shape=Sphere(radius=self.agent_radius), u_multiplier=0.7, rotatable=True,
                    sensors=[Lidar(world, n_rays=16, max_range=0.5)] if self.lidar else [],
                )
            )
        for i in range(self.n_lines):
            world.add_landmark(
                Landmark(name=f"line {i}", collide=True, movable=True, rotatable=True,
                         shape=Line(length=self.line_length), color=Color.BLACK)
            )
        for i in range(self.n_boxes):
            world.add_landmark(
                Landmark(name=f"box {i}", collide=True, movable=True, rotatable=True,
                         shape=Box(length=self.box_length, width=self.box_width), color=Color.RED)
            )
        return world

    def reset_world_at(self, state, generator):
        bounds = (-self.world_semidim, self.world_semidim)
        return ScenarioUtils.spawn_entities_randomly(
            self.world.agents + self.world.landmarks, self.world, state, generator,
            self.min_dist_between_entities, bounds, bounds,
        )

    def reward(self, agent, state):
        return torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)

    def observation(self, agent, state):
        if not self.lidar:
            return torch.zeros((state.batch_dim, 1), dtype=torch.float32, device=state.device)
        return agent.sensors[0].measure(state, vectorized=self.vectorized_lidar)
