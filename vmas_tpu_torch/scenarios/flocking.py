"""Flocking: the agents keep a desired distance from each other and a
target that circles on a script, seeing the obstacles with a Lidar.

Counterpart of vmas_tpu/scenarios/flocking.py. The target's clock ``t``
and the per-agent shaping baselines live in scratch. Its outputs come out
of the fused step as rows (``FlockingOutputs``): the pairwise distances
among all agents, the target included, with both reward terms and the
clock in the kernel; the Lidar runs on the plain ray cast in ``unpack``.
The target's script is a function of the clock alone, so the rows rollout
computes its actions for the whole horizon up front (``script_us``) and
they ride the action rows.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import X, Y, safe_norm
from vmas_tpu_torch.scenario import BaseHeuristicPolicy, BaseScenario
from vmas_tpu_torch.sensors import Lidar
from vmas_tpu_torch.utils import ScenarioUtils


def target_u(t):
    """The circling target's action at clock ``t`` (any shape): [cos(t /
    30), sin(t / 30)], the quotient one IEEE division, as the kernel's rows
    path and ``env.step`` take it alike."""
    t = F._div(t, 30.0)
    return torch.stack([torch.cos(t), torch.sin(t)], dim=-1)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 4)
        n_obstacles = kwargs.pop("n_obstacles", 5)
        self._min_dist_between_entities = kwargs.pop("min_dist_between_entities", 0.15)
        self.n_lidar_rays = kwargs.pop("n_lidar_rays", 12)
        self.collision_reward = kwargs.pop("collision_reward", -0.1)
        self.dist_shaping_factor = kwargs.pop("dist_shaping_factor", 1)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.plot_grid = True
        self.desired_distance = 0.1
        self.min_collision_distance = 0.005
        self.x_dim = 1
        self.y_dim = 1

        world = World(batch_dim, device, collision_force=400, substeps=5)

        def target_script(agent, world_, state):
            return agent.set_u(state, target_u(state.scenario["t"]))

        self._target = Agent(
            name="target", collide=True, color=Color.GREEN, render_action=True, action_script=target_script,
        )
        world.add_agent(self._target)
        goal_entity_filter = lambda e: not isinstance(e, Agent)
        for i in range(n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}", collide=True, render_action=True,
                    sensors=[Lidar(world, n_rays=self.n_lidar_rays, max_range=0.2, entity_filter=goal_entity_filter)],
                )
            )
        self.obstacles = []
        for i in range(n_obstacles):
            obstacle = Landmark(
                name=f"obstacle_{i}", collide=True, movable=False, shape=Sphere(radius=0.1), color=Color.RED,
            )
            world.add_landmark(obstacle)
            self.obstacles.append(obstacle)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        target_pos = torch.stack(
            [torch.zeros((B,), device=dev), torch.full((B,), -float(self.y_dim), device=dev)], dim=-1
        )
        state = self._target.set_pos(state, target_pos)
        state = ScenarioUtils.spawn_entities_randomly(
            self.obstacles + self.world.policy_agents, self.world, state, generator,
            self._min_dist_between_entities, x_bounds=(-self.x_dim, self.x_dim), y_bounds=(-self.y_dim, self.y_dim),
            occupied_positions=target_pos[:, None, :],
        )
        A = len(self.world.policy_agents)
        scratch = dict(state.scenario)
        scratch["t"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch["distance_shaping"] = self._dist_shaping(state)
        scratch["collision_rew"] = torch.zeros((B, A), dtype=torch.float32, device=dev)
        scratch["dist_rew"] = torch.zeros((B, A), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def _dist_shaping(self, state):
        """[B, A_policy] mean squared deviation from the desired distance to
        every other agent."""
        cols = []
        for agent in self.world.policy_agents:
            d = torch.stack(
                [safe_norm(agent.pos(state) - a.pos(state)) for a in self.world.agents if a is not agent], dim=1
            )
            cols.append(torch.mean((d - self.desired_distance) ** 2, dim=-1) * self.dist_shaping_factor)
        return torch.stack(cols, dim=-1)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        scratch["t"] = scratch["t"] + 1
        A = len(self.world.policy_agents)
        coll = torch.zeros((state.batch_dim, A), dtype=torch.float32, device=state.device)
        if self.collision_reward != 0:
            slot_of = {a.name: s for s, a in enumerate(self.world.policy_agents)}
            for i, a in enumerate(self.world.agents):
                for j, b in enumerate(self.world.agents):
                    if j <= i:
                        continue
                    hit = (self.world.get_distance(state, a, b) <= self.min_collision_distance).to(torch.float32)
                    for e in (a, b):
                        if e.action_script is None:
                            s = slot_of[e.name]
                            coll[:, s] = coll[:, s] + self.collision_reward * hit
        scratch["collision_rew"] = coll
        new_shaping = self._dist_shaping(state)
        scratch["dist_rew"] = scratch["distance_shaping"] - new_shaping
        scratch["distance_shaping"] = new_shaping
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        return s["collision_rew"][:, agent.slot - 1] + s["dist_rew"][:, agent.slot - 1]

    def observation(self, agent, state):
        return torch.cat(
            [agent.pos(state), agent.vel(state), agent.pos(state) - self._target.pos(state),
             agent.sensors[0].measure(state)],
            dim=-1,
        )

    def info(self, agent, state):
        s = state.scenario
        return {
            "agent_collision_rew": s["collision_rew"][:, agent.slot - 1],
            "agent_distance_rew": s["dist_rew"][:, agent.slot - 1],
        }

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return FlockingOutputs(self, world)


class FlockingOutputs(F.FusedOutputs):
    """Flocking's observations and rewards as extra rows of the fused step.
    ``emit`` is the plain version of the kernel's FlockingEmit, row for row
    in the JAX package's order; the Lidar is measured in ``unpack``.

    Rows: per policy agent pos, vel and pos - target (6); then the collision
    rewards (every pair of agents, the target's share dropped), the distance
    rewards and the new shapings (A each); then the clock, the previous
    clock plus one. Scratch in: the previous shapings and the clock, each
    carried from its emit row."""

    agent_w = 6

    def __init__(self, scenario, world):
        policy = world.policy_agents
        all_agents = world.agents  # the target, then the policy agents
        self.scenario = scenario
        self.n_agents = A = len(policy)
        self.all_i = [a.index for a in all_agents]
        self.all_r = [float(a.shape.radius) for a in all_agents]
        slot_of = {a.name: s for s, a in enumerate(policy)}
        # each agent's policy slot, -1 for the scripted target
        self.slot = [-1 if a.action_script is not None else slot_of[a.name] for a in all_agents]
        self.policy_pos = [all_agents.index(a) for a in policy]  # its position in all_agents
        self.target_i = scenario._target.index
        self.coll_rew = float(scenario.collision_reward)
        self.min_coll = float(scenario.min_collision_distance)
        self.desired = float(scenario.desired_distance)
        self.factor = float(scenario.dist_shaping_factor)
        self.base = A * self.agent_w
        self.n_scratch_in = A + 1
        self.n_out = self.base + 3 * A + 1
        self.carry_extra_idx = tuple(range(self.base + 2 * A, self.base + 3 * A)) + (self.base + 3 * A,)
        self.unpack_reads = ("state",)
        self.script_slots = (self.target_i,)
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return torch.cat([state.scenario["distance_shaping"].T, state.scenario["t"][None]], dim=0)

    @staticmethod
    def script_us(state, horizon):
        """The target's u at each step of a rollout of ``horizon`` steps from
        ``state``: its clock reads t0 + k at step k (pre_rewards adds one
        after the physics), an exact f32 integer."""
        t0 = state.scenario["t"]
        t = t0[None, :] + torch.arange(horizon, dtype=torch.float32, device=t0.device)[:, None]
        return (target_u(t),)

    def _dist(self, px, py, i, j):
        ai, aj = self.all_i[min(i, j)], self.all_i[max(i, j)]
        return F._norm(px[ai] - px[aj], py[ai] - py[aj])

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        prev = ctx["scratch"]
        A, n = self.n_agents, len(self.all_i)

        coll = [None] * A
        if self.coll_rew != 0:
            for i in range(n):
                for j in range(i + 1, n):
                    # the sphere-sphere distance, each radius subtracted
                    d = self._dist(px, py, i, j) - self.all_r[i] - self.all_r[j]
                    hit = (d <= self.min_coll).to(torch.float32) * self.coll_rew
                    for k in (i, j):
                        s = self.slot[k]
                        if s >= 0:
                            coll[s] = hit if coll[s] is None else coll[s] + hit
        coll = [c if c is not None else torch.zeros_like(px[0]) for c in coll]

        dist_rew, new_shaping = [], []
        for s, i in enumerate(self.policy_pos):
            ds = [self._dist(px, py, i, j) for j in range(n) if j != i]
            mean_sq = F._div(sum((d - self.desired) * (d - self.desired) for d in ds), float(len(ds)))
            shaping = mean_sq * self.factor
            new_shaping.append(shaping)
            dist_rew.append(prev[s] - shaping)

        rows = []
        for i in self.policy_pos:
            ai = self.all_i[i]
            rows += [px[ai], py[ai], vx[ai], vy[ai], px[ai] - px[self.target_i], py[ai] - py[self.target_i]]
        return rows + coll + dist_rew + new_shaping + [prev[A] + 1.0]

    def unpack(self, extra, state):
        """Output rows [n_out, B] -> (obs, rews, terminated, scratch
        updates), with ``state`` each env's (its Lidar's)."""
        A, w, base = self.n_agents, self.agent_w, self.base
        row = lambda r: extra[..., r, :]
        cols = lambda lo, hi: extra[..., lo:hi, :].transpose(-1, -2)
        obs = tuple(
            torch.cat([cols(i * w, (i + 1) * w), a.sensors[0].measure(state)], dim=-1)
            for i, a in enumerate(self.scenario.world.policy_agents)
        )
        rews = tuple(row(base + s) + row(base + A + s) for s in range(A))
        updates = {
            # the clock from its emit row, the previous clock plus one (the
            # state a rows rollout hands unpack holds the clock at its start)
            "t": row(base + 3 * A),
            "collision_rew": cols(base, base + A),
            "dist_rew": cols(base + A, base + 2 * A),
            "distance_shaping": cols(base + 2 * A, base + 3 * A),
        }
        return obs, rews, torch.zeros_like(row(base), dtype=torch.bool), updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if len(self.all_i) > K.MAX_A + 1 or self.n_scratch_in > K.MAX_K:
                raise NotImplementedError(f"the fused kernel's flocking emit takes at most {K.MAX_K - 1} agents")
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = ei
            p = ep.flocking
            p.n_agents, p.n_all, p.target = self.n_agents, len(self.all_i), self.target_i
            for k, (e, r, s) in enumerate(zip(self.all_i, self.all_r, self.slot)):
                p.all[k], p.radius[k], p.slot[k] = e, r, s
            for s, i in enumerate(self.policy_pos):
                p.policy[s] = i
            p.coll_rew, p.min_coll, p.desired, p.factor = self.coll_rew, self.min_coll, self.desired, self.factor
            self._kernel_emit = (K.EMIT_FLOCKING, ep)
        return self._kernel_emit


class HeuristicPolicy(BaseHeuristicPolicy):
    """The JAX package's flocking policy: circle the origin at radius 0.3,
    and step away from an obstacle the Lidar sees within 0.1."""

    def compute_action(self, observation, u_range):
        assert self.continuous_actions
        circle_radius = 0.3
        current_pos = observation[:, :2]
        v = current_pos
        norm_v = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        closest = v / torch.where(norm_v == 0, torch.ones_like(norm_v), norm_v) * circle_radius
        normal = torch.stack([closest[:, Y], -closest[:, X]], dim=1)
        n = torch.linalg.vector_norm(normal, dim=1, keepdim=True)
        normal = normal / torch.where(n == 0, torch.ones_like(n), n) * 0.1
        des_pos = closest + normal

        lidar = observation[:, 6:18]
        object_visible = torch.any(lidar < 0.1, dim=1)
        object_dir = torch.argmin(lidar, dim=1) / lidar.shape[1] * 2 * torch.pi
        object_vec = torch.stack([torch.cos(object_dir), torch.sin(object_dir)], dim=1)
        des_pos_object = current_pos - object_vec * 0.1
        des_pos = torch.where(object_visible[:, None], des_pos_object, des_pos)
        return torch.clamp((des_pos - current_pos) * 10, -u_range, u_range)
