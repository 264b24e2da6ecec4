"""Wind flocking: a big and a small agent fly against a wind; the small one
should shelter the big one, whose wind weakens the better the pair covers
the wind's direction. Both take velocity commands, which a PID velocity
controller per agent turns into forces.

Counterpart of vmas_tpu/scenarios/wind_flocking.py. Each agent's wind is its
per-env dynamic gravity (``WorldState.dyn_gravity``,
``Entity.set_gravity``), so with ``fused_physics=True`` every ``env.step``
runs the fused step (K1) with its dynamic-gravity rows and no emit; the
scenario has no fused outputs.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.controllers import VelocityController
from vmas_tpu_torch.core import Agent, Sphere, World
from vmas_tpu_torch.core.utils import X, Y, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


def angle_to_vector(angle):
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def get_line_angle_0_180(rot):
    # jnp.mod: the remainder takes the divisor's sign (torch.fmod would not)
    return torch.remainder(rot, math.pi)


def get_line_angle_dist_0_360(angle, goal):
    return -torch.sum(angle_to_vector(angle) * angle_to_vector(goal), dim=-1)


def get_line_angle_dist_0_180(angle, goal):
    angle = get_line_angle_0_180(angle)
    goal = get_line_angle_0_180(goal)
    return torch.minimum(
        torch.abs(angle - goal),
        torch.minimum(torch.abs(angle - (goal - math.pi)), torch.abs((angle - math.pi) - goal)),
    )


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.vel_shaping_factor = kwargs.pop("vel_shaping_factor", 1)
        self.dist_shaping_factor = kwargs.pop("dist_shaping_factor", 1)
        self.wind_shaping_factor = kwargs.pop("wind_shaping_factor", 1)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 0)
        self.rot_shaping_factor = kwargs.pop("rot_shaping_factor", 0)
        self.energy_shaping_factor = kwargs.pop("energy_shaping_factor", 0)
        self.observe_rel_pos = kwargs.pop("observe_rel_pos", False)
        self.observe_rel_vel = kwargs.pop("observe_rel_vel", False)
        self.observe_pos = kwargs.pop("observe_pos", True)
        self.use_controller = kwargs.pop("use_controller", True)
        wind = kwargs.pop("wind", 2)
        self.v_range = kwargs.pop("v_range", 0.5)
        desired_vel = kwargs.pop("desired_vel", self.v_range)
        self.f_range = kwargs.pop("f_range", 100)
        self.cover_angle_tolerance = kwargs.pop("cover_angle_tolerance", 1)
        self.horizon = kwargs.pop("horizon", 200)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        # the viewer's settings (render/viewer.py)
        self.plot_grid = True
        self.viewer_zoom = 2

        controller_params = [1.5, 0.6, 0.002]
        self.u_range = self.v_range if self.use_controller else self.f_range
        self.desired_distance = 1

        world = World(batch_dim, device, drag=0, linear_friction=0.1)
        world.dynamic_gravity = True
        dev = world.device
        self.wind_vec = torch.tensor([0.0, -wind], dtype=torch.float32, device=dev)
        self.desired_vel = torch.tensor([0.0, desired_vel], dtype=torch.float32, device=dev)
        self.max_pos = (self.horizon * world.dt) * desired_vel
        self.desired_pos = 10.0
        self.n_agents = 2

        self.big_agent = Agent(
            name="agent_0", render_action=True, shape=Sphere(radius=0.05),
            u_range=self.u_range, v_range=self.v_range, f_range=self.f_range,
        )
        world.add_agent(self.big_agent)
        self.small_agent = Agent(
            name="agent_1", render_action=True, shape=Sphere(radius=0.03),
            u_range=self.u_range, v_range=self.v_range, f_range=self.f_range,
        )
        world.add_agent(self.small_agent)
        self.controllers = {
            a.name: VelocityController(a, world, controller_params, "standard") for a in world.agents
        }
        return world

    def _agents_angle(self, state):
        d = self.big_agent.pos(state) - self.small_agent.pos(state)
        return torch.atan2(d[:, Y], d[:, X])

    def _shapings(self, state):
        """The pair's distance, position, rotation, per-agent velocity and
        per-agent wind shapings of ``state``."""
        big, small = self.big_agent, self.small_agent
        dist = torch.abs(safe_norm(small.pos(state) - big.pos(state)) - self.desired_distance) \
            * self.dist_shaping_factor
        pos = torch.abs(torch.maximum(big.pos(state)[:, Y], small.pos(state)[:, Y]) - self.desired_pos) \
            * self.pos_shaping_factor
        rot = get_line_angle_dist_0_180(self._agents_angle(state), torch.zeros_like(dist)) * self.rot_shaping_factor
        vel = torch.stack(
            [safe_norm(a.vel(state) - self.desired_vel) * self.vel_shaping_factor for a in self.world.agents], dim=-1
        )
        wind = torch.stack(
            [safe_norm(state.dyn_gravity[:, a.index]) * self.wind_shaping_factor for a in self.world.agents], dim=-1
        )
        return dist, pos, rot, vel, wind

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        start_angle = torch.rand((B,), generator=generator, device=dev) * (math.pi / 4) - math.pi / 8
        delta = torch.stack(
            [(self.desired_distance / 2) * torch.cos(start_angle),
             (self.desired_distance / 2) * torch.sin(start_angle)],
            dim=-1,
        )
        swap = torch.rand((B,), generator=generator, device=dev) < 0.5
        sign = torch.where(swap, -1.0, 1.0)[:, None]
        state = self.world.agents[0].set_pos(state, -sign * delta)
        state = self.world.agents[1].set_pos(state, sign * delta)
        for agent in self.world.agents:
            state = self.controllers[agent.name].reset(state)
            state = agent.set_gravity(state, self.wind_vec)

        dist, pos, rot, vel, wind = self._shapings(state)
        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
        zeros2 = torch.zeros((B, 2), dtype=torch.float32, device=dev)
        scratch = dict(state.scenario)
        scratch.update(
            t=torch.zeros((B,), dtype=torch.int32, device=dev),
            vel_shaping=vel, energy_shaping=zeros2, wind_shaping=wind, distance_shaping=dist,
            pos_shaping=pos, rot_shaping=rot,
            dist_rew=zeros, rot_rew=zeros, pos_rew=zeros, vel_reward=zeros, energy_rew=zeros, wind_rew=zeros,
            agent_wind_rew=zeros2, agent_vel_rew=zeros2, agent_energy_rew=zeros2,
        )
        return state.replace(scenario=scratch)

    def process_action(self, agent, state):
        if self.use_controller:
            return self.controllers[agent.name].process_force(state)
        return state

    def _set_friction(self, state):
        """Scale the big agent's wind by how well the pair covers the wind
        direction (the JAX package's _set_friction)."""
        angle = self._agents_angle(state)
        d = get_line_angle_dist_0_360(angle, torch.full_like(angle, -math.pi / 2)) + 1
        d = torch.clamp(d, max=self.cover_angle_tolerance) + (1 - self.cover_angle_tolerance)
        d = (d - 1 + self.cover_angle_tolerance) / self.cover_angle_tolerance
        return self.big_agent.set_gravity(state, self.wind_vec[None] * d[:, None])

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        scratch["t"] = scratch["t"] + 1
        t = scratch["t"]
        state = self._set_friction(state.replace(scenario=scratch))
        scratch = dict(state.scenario)
        dist, pos, rot, vel, wind = self._shapings(state)

        scratch["dist_rew"] = scratch["distance_shaping"] - dist
        scratch["distance_shaping"] = dist
        scratch["rot_rew"] = scratch["rot_shaping"] - rot
        scratch["rot_shaping"] = rot
        scratch["pos_rew"] = scratch["pos_shaping"] - pos
        scratch["pos_shaping"] = pos

        scratch["agent_vel_rew"] = scratch["vel_shaping"] - vel
        scratch["vel_shaping"] = vel
        scratch["vel_reward"] = scratch["agent_vel_rew"].mean(-1)

        energy = torch.stack(
            [safe_norm(a.u(state)) * self.energy_shaping_factor for a in self.world.agents], dim=-1
        )
        agent_energy_rew = torch.where((t < 10)[:, None], 0.0, scratch["energy_shaping"] - energy)
        scratch["agent_energy_rew"] = agent_energy_rew
        scratch["energy_shaping"] = energy
        scratch["energy_rew"] = agent_energy_rew.mean(-1)

        agent_wind_rew = torch.where((t < 5)[:, None], 0.0, scratch["wind_shaping"] - wind)
        scratch["agent_wind_rew"] = agent_wind_rew
        scratch["wind_shaping"] = wind
        scratch["wind_rew"] = agent_wind_rew.mean(-1)
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        return s["dist_rew"] + s["vel_reward"] + s["rot_rew"] + s["energy_rew"] + s["wind_rew"] + s["pos_rew"]

    def observation(self, agent, state):
        observations = []
        if self.observe_pos:
            observations.append(agent.pos(state))
        observations.append(agent.vel(state))
        if self.observe_rel_pos:
            observations += [a.pos(state) - agent.pos(state) for a in self.world.agents if a is not agent]
        if self.observe_rel_vel:
            observations += [a.vel(state) - agent.vel(state) for a in self.world.agents if a is not agent]
        return torch.cat(observations, dim=-1)

    def info(self, agent, state):
        s = state.scenario
        i = agent.slot
        return {
            "dist_rew": s["dist_rew"],
            "rot_rew": s["rot_rew"],
            "pos_rew": s["pos_rew"],
            "agent_wind_rew": s["agent_wind_rew"][:, i],
            "agent_vel_rew": s["agent_vel_rew"][:, i],
            "agent_energy_rew": s["agent_energy_rew"][:, i],
            "delta_vel_to_goal": safe_norm(agent.vel(state) - self.desired_vel),
        }

    def extra_render(self, env, ax, env_index: int = 0):
        """The pair's axis line, centred between the agents, and the goal's Y
        line."""
        import numpy as np

        from vmas_tpu_torch.render import draw

        state = env.state
        pb = self.big_agent.pos(state)[env_index].numpy()
        ps = self.small_agent.pos(state)[env_index].numpy()
        mid = (pb + ps) / 2
        ang = np.arctan2(*(pb - ps)[::-1])
        d = self.desired_distance / 2 * np.array([np.cos(ang), np.sin(ang)])
        draw.draw_line(ax, mid - d, mid + d, (0, 0, 0))
        half = self.desired_distance / 2
        draw.draw_line(ax, (-half, self.max_pos), (half, self.max_pos), (1, 0, 0))
