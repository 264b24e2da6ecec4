"""Asymmetric joint (debug): two agents joined by a bar, with a heavy mass
fixed off-centre on it, turn the bar to a goal angle of 90 degrees.

Counterpart of vmas_tpu/scenarios/debug/asym_joint.py. Its world drives
three joints (the agents to the ends of the bar, the mass to the bar) and 10
substeps (7 without ``asym_package``). It has no fused outputs, as in the
JAX package: with ``fused_physics=True`` the fused step runs its physics
with no emit, and the hooks (the observation noise and the energy term among
them) run around it; it has no rows rollout.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.core import Agent, Color, Joint, Landmark, Sphere, World
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.joint_passage import _angle_to_vector
from vmas_tpu_torch.scenarios.joint_passage_size import _angle_dist_180
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.joint_length = kwargs.pop("joint_length", 0.5)
        self.random_start_angle = kwargs.pop("random_start_angle", False)
        self.observe_joint_angle = kwargs.pop("observe_joint_angle", False)
        self.joint_angle_obs_noise = kwargs.pop("joint_angle_obs_noise", 0.0)
        self.asym_package = kwargs.pop("asym_package", True)
        self.mass_ratio = kwargs.pop("mass_ratio", 5)
        self.mass_position = kwargs.pop("mass_position", 0.75)
        self.max_speed_1 = kwargs.pop("max_speed_1", None)
        self.obs_noise = kwargs.pop("obs_noise", 0.2)
        self.rot_shaping_factor = kwargs.pop("rot_shaping_factor", 1)
        self.energy_reward_coeff = kwargs.pop("energy_reward_coeff", 0.08)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(
            batch_dim, device,
            substeps=7 if not self.asym_package else 10,
            joint_force=900 if self.asym_package else 400,
            drag=0.25 if not self.asym_package else 0.15,
        )
        if not self.observe_joint_angle:
            assert self.joint_angle_obs_noise == 0
        self.goal_angle = math.pi / 2
        self.n_agents = 2
        self.agent_radius = 0.03333
        self.mass_radius = self.agent_radius * (2 / 3)

        world.add_agent(
            Agent(name="agent 0", shape=Sphere(self.agent_radius), u_multiplier=0.8, obs_noise=self.obs_noise,
                  render_action=True)
        )
        world.add_agent(
            Agent(name="agent 1", shape=Sphere(self.agent_radius), u_multiplier=0.8,
                  mass=1 if self.asym_package else self.mass_ratio, max_speed=self.max_speed_1,
                  obs_noise=self.obs_noise, render_action=True)
        )
        self.joint = Joint(
            world.agents[0], world.agents[1], anchor_a=(0, 0), anchor_b=(0, 0), dist=self.joint_length,
            rotate_a=True, rotate_b=True, collidable=False, width=0, mass=1,
        )
        world.add_joint(self.joint)
        if self.asym_package:
            self.mass = Landmark(
                name="mass", shape=Sphere(radius=self.mass_radius), collide=False, movable=True,
                color=Color.BLACK, mass=self.mass_ratio, collision_filter=lambda e: not isinstance(e.shape, Sphere),
            )
            world.add_landmark(self.mass)
            world.add_joint(Joint(self.mass, self.joint.landmark, anchor_a=(0, 0), anchor_b=(self.mass_position, 0),
                                  dist=0, rotate_a=True, rotate_b=True))
        return world

    def _dist_to_goal(self, state):
        """The bar's angle distance to the goal angle, mod pi."""
        rot = self.joint.landmark.rot(state)
        return _angle_dist_180(rot, torch.full_like(rot, self.goal_angle))

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        lim = math.pi / 2 if self.random_start_angle else 0.0
        start_angle = torch.rand((B,), generator=generator, device=dev) * (2 * lim) - lim
        delta = torch.stack(
            [(self.joint_length / 2) * torch.cos(start_angle), (self.joint_length / 2) * torch.sin(start_angle)],
            dim=-1,
        )
        joint_pos = torch.zeros((B, 2), dtype=torch.float32, device=dev)
        # a per-env swap of the agents' ends (the original's randperm)
        swap = torch.rand((B,), generator=generator, device=dev) < 0.5
        sign = torch.where(swap, -1.0, 1.0)[:, None]
        state = self.world.agents[0].set_pos(state, joint_pos - sign * delta)
        state = self.world.agents[1].set_pos(state, joint_pos + sign * delta)
        if self.asym_package:
            state = self.mass.set_pos(state, joint_pos + self.mass_position * delta * sign)

        state = self.world.sync_joints(state)
        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch = dict(state.scenario)
        scratch["rot_shaping_pre"] = self._dist_to_goal(state) * self.rot_shaping_factor
        scratch["rot_rew"] = zeros
        scratch["energy_rew"] = zeros
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        joint_shaping = self._dist_to_goal(state) * self.rot_shaping_factor
        scratch["rot_rew"] = scratch["rot_shaping_pre"] - joint_shaping
        scratch["rot_shaping_pre"] = joint_shaping
        energy = torch.stack(
            [
                safe_norm(a.u(state))
                / math.sqrt(self.world.dim_p * float((a.u_range_array[0] * a.u_multiplier_array[0]) ** 2))
                for a in self.world.agents
            ],
            dim=1,
        ).sum(-1)
        scratch["energy_rew"] = -energy * self.energy_reward_coeff
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["rot_rew"] + state.scenario["energy_rew"]

    def observation(self, agent, state):
        parts = [agent.pos(state), agent.vel(state)]
        if self.observe_joint_angle:
            joint_angle = self.joint.landmark.rot(state)
            if self.joint_angle_obs_noise:
                gen = self.obs_generator(100 + agent.slot)
                joint_angle = joint_angle + (
                    torch.randn(joint_angle.shape, generator=gen, device=joint_angle.device)
                    * self.joint_angle_obs_noise
                )
            parts.append(_angle_to_vector(joint_angle))
        if self.obs_noise > 0:
            parts = [
                p + (torch.rand(p.shape, generator=self.obs_generator(agent.slot * 10 + i), device=p.device) * 2 - 1)
                * self.obs_noise
                for i, p in enumerate(parts)
            ]
        return torch.cat(parts, dim=-1)

    def done(self, state):
        return self._dist_to_goal(state) <= 0.01

    def info(self, agent, state):
        return {"rot_rew": state.scenario["rot_rew"], "energy_rew": state.scenario["energy_rew"]}

    def extra_render(self, env, ax, env_index: int = 0):
        """A green marker at the origin."""
        from vmas_tpu_torch.render import draw

        draw.draw_circle(ax, (0.0, 0.0), 0.01, Color.GREEN, filled=True)
