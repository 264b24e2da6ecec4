"""Discovery: the agents cover targets, ``agents_per_target`` of them within
the covering range at once; a covered target respawns (or, with
``targets_respawn=False``, leaves the arena).

Counterpart of vmas_tpu/scenarios/discovery.py. The respawn runs in
``post_rewards``, drawing from the step's own stream (``obs_generator``,
seeded from the environment's generator at each step) where the JAX package
keeps a key in scratch. Its outputs come out of the fused step as rows
(``DiscoveryOutputs``): the agent-target coverage matrix, the covering
rewards and the collision penalties in the kernel. The Lidar must see the
targets where the respawn put them, so it is measured in ``finish_obs``,
after post_rewards, as the hook pipeline orders it; the rows rollouts
therefore refuse discovery.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseHeuristicPolicy, BaseScenario
from vmas_tpu_torch.sensors import Lidar
from vmas_tpu_torch.utils import ScenarioUtils

# the index of the respawn's stream among the step's seeded streams
# (BaseScenario.obs_generator), apart from the agents' observation noise
_RESPAWN_STREAM = 1000


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 5)
        self.n_targets = kwargs.pop("n_targets", 7)
        self.x_semidim = kwargs.pop("x_semidim", 1)
        self.y_semidim = kwargs.pop("y_semidim", 1)
        self._min_dist_between_entities = kwargs.pop("min_dist_between_entities", 0.2)
        self._lidar_range = kwargs.pop("lidar_range", 0.35)
        self._covering_range = kwargs.pop("covering_range", 0.25)
        self.use_agent_lidar = kwargs.pop("use_agent_lidar", False)
        self.n_lidar_rays_entities = kwargs.pop("n_lidar_rays_entities", 15)
        self.n_lidar_rays_agents = kwargs.pop("n_lidar_rays_agents", 12)
        self._agents_per_target = kwargs.pop("agents_per_target", 2)
        self.targets_respawn = kwargs.pop("targets_respawn", True)
        self.shared_reward = kwargs.pop("shared_reward", False)
        self.agent_collision_penalty = kwargs.pop("agent_collision_penalty", 0)
        self.covering_rew_coeff = kwargs.pop("covering_rew_coeff", 1.0)
        self.time_penalty = kwargs.pop("time_penalty", 0)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self._comms_range = self._lidar_range
        self.min_collision_distance = 0.005
        self.agent_radius = 0.05
        self.target_radius = self.agent_radius
        self.viewer_zoom = 1
        self.target_color = Color.GREEN

        world = World(
            batch_dim, device, x_semidim=self.x_semidim, y_semidim=self.y_semidim,
            collision_force=500, substeps=2, drag=0.25,
        )
        entity_filter_agents = lambda e: e.name.startswith("agent")
        entity_filter_targets = lambda e: e.name.startswith("target")
        for i in range(self.n_agents):
            sensors = [Lidar(world, n_rays=self.n_lidar_rays_entities, max_range=self._lidar_range,
                             entity_filter=entity_filter_targets, render_color=Color.GREEN)]
            if self.use_agent_lidar:
                sensors.append(Lidar(world, angle_start=0.05, angle_end=2 * math.pi + 0.05,
                                     n_rays=self.n_lidar_rays_agents, max_range=self._lidar_range,
                                     entity_filter=entity_filter_agents, render_color=Color.BLUE))
            world.add_agent(
                Agent(name=f"agent_{i}", collide=True, shape=Sphere(radius=self.agent_radius), sensors=sensors)
            )
        self._targets = []
        for i in range(self.n_targets):
            target = Landmark(
                name=f"target_{i}", collide=True, movable=False, shape=Sphere(radius=self.target_radius),
                color=self.target_color,
            )
            world.add_landmark(target)
            self._targets.append(target)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        state = ScenarioUtils.spawn_entities_randomly(
            self._targets + self.world.agents, self.world, state, generator, self._min_dist_between_entities,
            x_bounds=(-self.x_semidim, self.x_semidim), y_bounds=(-self.y_semidim, self.y_semidim),
        )
        scratch = dict(state.scenario)
        scratch["all_time_covered"] = torch.zeros((B, self.n_targets), dtype=torch.bool, device=dev)
        scratch["covered_targets"] = torch.zeros((B, self.n_targets), dtype=torch.bool, device=dev)
        scratch["covering_rew"] = torch.zeros((B, self.n_agents), dtype=torch.float32, device=dev)
        scratch["shared_covering_rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch["collision_rew"] = torch.zeros((B, self.n_agents), dtype=torch.float32, device=dev)
        scratch["time_rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def _dists(self, state):
        a_pos = state.pos[:, [a.index for a in self.world.agents]]  # [B, A, 2]
        t_pos = state.pos[:, [t.index for t in self._targets]]  # [B, T, 2]
        return safe_norm(a_pos[:, :, None, :] - t_pos[:, None, :, :])  # [B, A, T]

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        B = state.batch_dim
        in_range = self._dists(state) < self._covering_range  # [B, A, T]
        covered = in_range.sum(dim=1) >= self._agents_per_target  # [B, T]
        scratch["covered_targets"] = covered
        scratch["time_rew"] = torch.full((B,), float(self.time_penalty), dtype=torch.float32, device=state.device)
        covering_rew = (in_range & covered[:, None, :]).sum(-1).to(torch.float32) * self.covering_rew_coeff
        scratch["covering_rew"] = covering_rew  # [B, A]
        shared = covering_rew.sum(-1)
        scratch["shared_covering_rew"] = torch.where(shared != 0, shared / 2, shared)

        coll = torch.zeros((B, self.n_agents), dtype=torch.float32, device=state.device)
        if self.agent_collision_penalty != 0:
            # all agents are spheres: one [B, A, A] pairwise distance
            a_pos = state.pos[:, [a.index for a in self.world.agents]]
            radii = torch.tensor([a.shape.radius for a in self.world.agents], device=state.device)
            d = safe_norm(a_pos[:, :, None, :] - a_pos[:, None, :, :]) - radii[None, :, None] - radii[None, None, :]
            eye = torch.eye(self.n_agents, dtype=torch.bool, device=state.device)
            hit = (d < self.min_collision_distance) & ~eye[None]
            coll = self.agent_collision_penalty * hit.sum(-1).to(torch.float32)
        scratch["collision_rew"] = coll
        return state.replace(scenario=scratch)

    def post_rewards(self, state):
        """The covered targets respawn clear of the agents and the other
        targets (or leave the arena with ``targets_respawn=False``)."""
        scratch = dict(state.scenario)
        covered = scratch["covered_targets"]
        B, dev = state.batch_dim, state.device
        generator = self.obs_generator(_RESPAWN_STREAM)
        if self.targets_respawn:
            agents_pos = state.pos[:, [a.index for a in self.world.agents]]
            for i, target in enumerate(self._targets):
                others = torch.stack([o.pos(state) for o in self._targets if o is not target], dim=1)
                occupied = torch.cat([agents_pos, others], dim=1)
                pos = ScenarioUtils.find_random_pos_for_entity_vectorized(
                    occupied, generator, self.world, self._min_dist_between_entities,
                    (-self.x_semidim, self.x_semidim), (-self.y_semidim, self.y_semidim),
                )
                state = target.set_pos(state, pos[:, 0], env_mask=covered[:, i])
        else:
            scratch["all_time_covered"] = scratch["all_time_covered"] | covered
            lo, hi = -1000 * self.x_semidim, -10 * self.x_semidim
            outside = torch.rand((B, 2), generator=generator, device=dev) * (hi - lo) + lo
            for i, target in enumerate(self._targets):
                state = target.set_pos(state, outside, env_mask=covered[:, i])
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        covering = s["shared_covering_rew"] if self.shared_reward else s["covering_rew"][:, agent.slot]
        return s["collision_rew"][:, agent.slot] + covering + s["time_rew"]

    def observation(self, agent, state):
        obs = [agent.pos(state), agent.vel(state), agent.sensors[0].measure(state)]
        if self.use_agent_lidar:
            obs.append(agent.sensors[1].measure(state))
        return torch.cat(obs, dim=-1)

    def info(self, agent, state):
        s = state.scenario
        return {
            "covering_reward": s["shared_covering_rew"] if self.shared_reward else s["covering_rew"][:, agent.slot],
            "collision_rew": s["collision_rew"][:, agent.slot],
            "targets_covered": s["covered_targets"].sum(-1),
        }

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return DiscoveryOutputs(self, world)

    def extra_render(self, env, ax, env_index: int = 0):
        """The targets' covering-range circles and the agents' communication
        lines."""
        from vmas_tpu_torch.render import draw

        pos = env.state.pos[env_index].numpy()
        for target in self._targets:
            draw.draw_circle(ax, pos[target.index], self._covering_range, Color.GREEN)
        draw.draw_comm_lines(ax, env, env.state, env_index, self._comms_range)


class DiscoveryOutputs(F.FusedOutputs):
    """Discovery's observations (but the Lidar) and rewards as extra rows of
    the fused step. ``emit`` is the plain version of the kernel's
    DiscoveryEmit, row for row in the JAX package's order; post_rewards
    respawns the covered targets from the unpacked flags, and
    ``finish_obs`` then appends the Lidar.

    Rows: per agent pos and vel (4); the covering rewards (A); the covered
    flags (T); the shared reward; with a collision penalty, per agent the
    penalty times its count of agents closer than the minimum distance (A).
    No scratch in."""

    def __init__(self, scenario, world):
        agents = world.policy_agents
        self.scenario = scenario
        self.n_agents = A = len(agents)
        self.n_targets = T = len(scenario._targets)
        self.agent_i = [a.index for a in agents]
        self.target_i = [t.index for t in scenario._targets]
        self.cover_r = float(scenario._covering_range)
        self.per_target = int(scenario._agents_per_target)
        self.coeff = float(scenario.covering_rew_coeff)
        self.time_pen = float(scenario.time_penalty)
        self.coll_pen = float(scenario.agent_collision_penalty)
        self.min_coll = float(scenario.min_collision_distance)
        self.radii = [float(a.shape.radius) for a in agents]
        self.shared = bool(scenario.shared_reward)
        self.use_agent_lidar = bool(scenario.use_agent_lidar)
        self.n_out = 4 * A + A + T + 1 + (A if self.coll_pen != 0 else 0)
        self._kernel_emit = None

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        A, T = self.n_agents, self.n_targets
        in_range = [
            [F._norm(px[a] - px[t], py[a] - py[t]) < self.cover_r for t in self.target_i] for a in self.agent_i
        ]
        # each sum as Python's, from 0
        covered = [sum(in_range[i][k].to(torch.float32) for i in range(A)) >= float(self.per_target)
                   for k in range(T)]
        covering = [sum((in_range[i][k] & covered[k]).to(torch.float32) for k in range(T)) * self.coeff
                    for i in range(A)]
        shared_rew = sum(covering)
        shared_rew = torch.where(shared_rew != 0, F._div(shared_rew, 2.0), shared_rew)

        rows = []
        for a in self.agent_i:
            rows += [px[a], py[a], vx[a], vy[a]]
        rows += covering + [c.to(torch.float32) for c in covered] + [shared_rew]
        if self.coll_pen != 0:
            for i, ai in enumerate(self.agent_i):
                c = torch.zeros_like(px[0])
                for j, aj in enumerate(self.agent_i):
                    if j == i:
                        continue
                    d = F._norm(px[ai] - px[aj], py[ai] - py[aj]) - self.radii[i] - self.radii[j]
                    c = c + (d < self.min_coll).to(torch.float32)
                rows.append(c * self.coll_pen)
        return rows

    def unpack(self, extra, state):
        """Output rows [..., n_out, B] -> (obs without the Lidar, rews,
        terminated, scratch updates)."""
        A, T = self.n_agents, self.n_targets
        row = lambda r: extra[..., r, :]
        cols = lambda lo, hi: extra[..., lo:hi, :].transpose(-1, -2)
        covering = cols(4 * A, 5 * A)
        shared_rew = row(5 * A + T)
        if self.coll_pen != 0:
            coll = cols(5 * A + T + 1, 6 * A + T + 1)
        else:
            coll = torch.zeros_like(covering)
        time_rew = torch.full_like(shared_rew, self.time_pen)
        # the Lidar is measured in finish_obs, after post_rewards
        obs = tuple(cols(4 * i, 4 * (i + 1)) for i in range(A))
        rews = tuple(coll[..., i] + (shared_rew if self.shared else covering[..., i]) + time_rew for i in range(A))
        updates = {
            "covered_targets": cols(5 * A, 5 * A + T) > 0.5,
            "covering_rew": covering,
            "shared_covering_rew": shared_rew,
            "collision_rew": coll,
            "time_rew": time_rew,
        }
        return obs, rews, torch.zeros_like(shared_rew, dtype=torch.bool), updates

    def finish_obs(self, obs, state):
        out = []
        for o, a in zip(obs, self.scenario.world.policy_agents):
            parts = [o, a.sensors[0].measure(state)]
            if self.use_agent_lidar:
                parts.append(a.sensors[1].measure(state))
            out.append(torch.cat(parts, dim=-1))
        return tuple(out)

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A or self.n_targets > K.MAX_E:
                raise NotImplementedError(f"the fused kernel's discovery emit takes at most {K.MAX_A} agents")
            ep = K.EmitParams()
            p = ep.discovery
            p.n_agents, p.n_targets = self.n_agents, self.n_targets
            for i, (a, r) in enumerate(zip(self.agent_i, self.radii)):
                p.agent[i], p.radius[i] = a, r
            for k, t in enumerate(self.target_i):
                p.target[k] = t
            p.cover_r, p.per_target, p.coeff = self.cover_r, float(self.per_target), self.coeff
            p.coll_pen, p.min_coll, p.with_coll = self.coll_pen, self.min_coll, self.coll_pen != 0
            self._kernel_emit = (K.EMIT_DISCOVERY, ep)
        return self._kernel_emit


class HeuristicPolicy(BaseHeuristicPolicy):
    """The JAX package's discovery policy: orbit a circle of radius 0.75,
    dive at a target the target Lidar sees within 0.3, and back off from an
    agent the agent Lidar (where there is one) sees within 0.15."""

    def compute_action(self, observation, u_range):
        assert self.continuous_actions
        circle_radius = 0.75
        current_pos = observation[:, :2]
        v = current_pos
        norm_v = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        closest = v / torch.where(norm_v == 0, torch.ones_like(norm_v), norm_v) * circle_radius
        normal = torch.stack([closest[:, 1], -closest[:, 0]], dim=1)
        n = torch.linalg.vector_norm(normal, dim=1, keepdim=True)
        normal = normal / torch.where(n == 0, torch.ones_like(n), n) * 0.1
        des_pos = closest + normal

        lidar_targets = observation[:, 4:19]
        target_visible = torch.any(lidar_targets < 0.3, dim=1)
        target_dir = torch.argmin(lidar_targets, dim=1) / lidar_targets.shape[1] * 2 * torch.pi
        target_vec = torch.stack([torch.cos(target_dir), torch.sin(target_dir)], dim=1)
        des_pos = torch.where(target_visible[:, None], current_pos + target_vec * 0.1, des_pos)

        if observation.shape[-1] > 19:
            lidar_agents = observation[:, 19:31]
            agent_visible = torch.any(lidar_agents < 0.15, dim=1)
            agent_dir = torch.argmin(lidar_agents, dim=1) / lidar_agents.shape[1] * 2 * torch.pi
            agent_vec = torch.stack([torch.cos(agent_dir), torch.sin(agent_dir)], dim=1)
            des_pos = torch.where(agent_visible[:, None], current_pos - agent_vec * 0.1, des_pos)

        return torch.clamp((des_pos - current_pos) * 10, -u_range, u_range)
