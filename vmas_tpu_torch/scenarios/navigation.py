"""Navigation: each agent reaches its own goal, seeing the other agents with
a Lidar.

Counterpart of vmas_tpu/scenarios/navigation.py. The per-agent shaping
baselines and collision rewards are ``[B, A]`` scratch tensors. Its outputs
come out of the fused step as rows (``NavigationOutputs``), the goal terms
and the pairwise collision penalties in the kernel; the Lidar runs on the
plain ray cast in ``unpack`` (``unpack_reads = ("state",)`` with collisions
on, so the rows rollout rebuilds each step's state for it).
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseHeuristicPolicy, BaseScenario
from vmas_tpu_torch.sensors import Lidar
from vmas_tpu_torch.utils import ScenarioUtils


def _row_sum(rows):
    """The sum of the rows in their order, from the first."""
    total = rows[0]
    for r in rows[1:]:
        total = total + r
    return total


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.plot_grid = False
        self.n_agents = kwargs.pop("n_agents", 4)
        self.collisions = kwargs.pop("collisions", True)
        self.world_spawning_x = kwargs.pop("world_spawning_x", 1)
        self.world_spawning_y = kwargs.pop("world_spawning_y", 1)
        self.enforce_bounds = kwargs.pop("enforce_bounds", False)
        self.agents_with_same_goal = kwargs.pop("agents_with_same_goal", 1)
        self.split_goals = kwargs.pop("split_goals", False)
        self.observe_all_goals = kwargs.pop("observe_all_goals", False)
        self.lidar_range = kwargs.pop("lidar_range", 0.35)
        self.agent_radius = kwargs.pop("agent_radius", 0.1)
        self.comms_range = kwargs.pop("comms_range", 0)
        self.n_lidar_rays = kwargs.pop("n_lidar_rays", 12)
        self.shared_rew = kwargs.pop("shared_rew", True)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.final_reward = kwargs.pop("final_reward", 0.01)
        self.agent_collision_penalty = kwargs.pop("agent_collision_penalty", -1)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.min_distance_between_entities = self.agent_radius * 2 + 0.05
        self.min_collision_distance = 0.005

        x_semidim = self.world_spawning_x if self.enforce_bounds else None
        y_semidim = self.world_spawning_y if self.enforce_bounds else None

        assert 1 <= self.agents_with_same_goal <= self.n_agents
        if self.agents_with_same_goal > 1:
            assert not self.collisions, "If agents share goals they cannot be collidables"
        if self.split_goals:
            assert (
                self.n_agents % 2 == 0 and self.agents_with_same_goal == self.n_agents // 2
            ), "Splitting the goals is allowed when the agents are even and half the team has the same goal"

        world = World(batch_dim, device, substeps=2, x_semidim=x_semidim, y_semidim=y_semidim)

        known_colors = [
            (0.22, 0.49, 0.72), (1.00, 0.50, 0), (0.30, 0.69, 0.29),
            (0.97, 0.51, 0.75), (0.60, 0.31, 0.64), (0.89, 0.10, 0.11), (0.87, 0.87, 0),
        ]
        entity_filter_agents = lambda e: isinstance(e, Agent)

        self.goals = []
        for i in range(self.n_agents):
            color = known_colors[i % len(known_colors)]
            agent = Agent(
                name=f"agent_{i}", collide=self.collisions, color=color,
                shape=Sphere(radius=self.agent_radius), render_action=True,
                sensors=(
                    [Lidar(world, n_rays=self.n_lidar_rays, max_range=self.lidar_range,
                           entity_filter=entity_filter_agents)]
                    if self.collisions
                    else None
                ),
            )
            world.add_agent(agent)
            goal = Landmark(name=f"goal {i}", collide=False, color=color)
            world.add_landmark(goal)
            agent.goal = goal
            self.goals.append(goal)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        bounds = ((-self.world_spawning_x, self.world_spawning_x), (-self.world_spawning_y, self.world_spawning_y))
        state = ScenarioUtils.spawn_entities_randomly(
            self.world.agents, self.world, state, generator, self.min_distance_between_entities, *bounds
        )
        occupied = state.pos[:, [a.index for a in self.world.agents]]
        goal_poses = []
        for _ in range(self.n_agents):
            pos = ScenarioUtils.find_random_pos_for_entity(
                occupied, generator, self.world, self.min_distance_between_entities, *bounds
            )
            goal_poses.append(pos[:, 0])
            occupied = torch.cat([occupied, pos], dim=1)

        for i, agent in enumerate(self.world.agents):
            if self.split_goals:
                goal_index = int(i // self.agents_with_same_goal)
            else:
                goal_index = 0 if i < self.agents_with_same_goal else i
            state = agent.goal.set_pos(state, goal_poses[goal_index])

        pos_shaping = torch.stack(
            [safe_norm(a.pos(state) - a.goal.pos(state)) * self.pos_shaping_factor for a in self.world.agents],
            dim=-1,
        )
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        scratch = dict(state.scenario)
        scratch["pos_shaping"] = pos_shaping  # [B, A]
        scratch["pos_rew_per_agent"] = z(B, self.n_agents)
        scratch["collision_rew"] = z(B, self.n_agents)
        scratch["pos_rew"] = z(B)
        scratch["final_rew"] = z(B)
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        dist = torch.stack([safe_norm(a.pos(state) - a.goal.pos(state)) for a in self.world.agents], dim=-1)
        goal_r = torch.tensor([a.goal.shape.radius for a in self.world.agents], device=state.device)
        on_goal = dist < goal_r[None]
        pos_shaping = dist * self.pos_shaping_factor
        per_agent = scratch["pos_shaping"] - pos_shaping
        scratch["pos_shaping"] = pos_shaping
        scratch["pos_rew_per_agent"] = per_agent
        scratch["pos_rew"] = _row_sum(list(per_agent.unbind(-1)))
        scratch["final_rew"] = torch.where(torch.all(on_goal, dim=-1), self.final_reward, 0.0)

        coll = torch.zeros_like(per_agent)
        for i, a in enumerate(self.world.agents):
            for j, b in enumerate(self.world.agents):
                if i <= j or not self.world.collides(a, b):
                    continue
                d = self.world.get_distance(state, a, b)
                hit = (d <= self.min_collision_distance).to(torch.float32)
                coll[:, i] = coll[:, i] + self.agent_collision_penalty * hit
                coll[:, j] = coll[:, j] + self.agent_collision_penalty * hit
        scratch["collision_rew"] = coll
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        pos_reward = s["pos_rew"] if self.shared_rew else s["pos_rew_per_agent"][:, agent.slot]
        return pos_reward + s["final_rew"] + s["collision_rew"][:, agent.slot]

    def observation(self, agent, state):
        if self.observe_all_goals:
            goal_poses = [agent.pos(state) - a.goal.pos(state) for a in self.world.agents]
        else:
            goal_poses = [agent.pos(state) - agent.goal.pos(state)]
        lidar = [agent.sensors[0].max_range - agent.sensors[0].measure(state)] if self.collisions else []
        return torch.cat([agent.pos(state), agent.vel(state)] + goal_poses + lidar, dim=-1)

    def done(self, state):
        return torch.stack(
            [safe_norm(a.pos(state) - a.goal.pos(state)) < a.shape.radius for a in self.world.agents], dim=-1
        ).all(-1)

    def info(self, agent, state):
        s = state.scenario
        return {
            "pos_rew": s["pos_rew"] if self.shared_rew else s["pos_rew_per_agent"][:, agent.slot],
            "final_rew": s["final_rew"],
            "agent_collisions": s["collision_rew"][:, agent.slot],
        }

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return NavigationOutputs(self, world)

    def extra_render(self, env, ax, env_index: int = 0):
        """The agents' communication lines."""
        from vmas_tpu_torch.render import draw

        draw.draw_comm_lines(ax, env, env.state, env_index, self.comms_range)


class NavigationOutputs(F.FusedOutputs):
    """Navigation's observations, rewards and done as extra rows of the
    fused step. ``emit`` is the plain version of the kernel's NavigationEmit,
    row for row in the JAX package's order; the Lidar is measured in
    ``unpack``, on the state it is given.

    Rows: per agent pos, vel and pos - goal (each goal's with
    ``observe_all_goals``): ``obs_w`` = 4 + 2 (or 2A); then the per-agent
    position rewards, the collision penalties (each colliding pair, the
    radii subtracted one at a time) and the new shapings (A each); then
    final_rew and done. Scratch in: the previous shapings, carried from
    their emit rows."""

    def __init__(self, scenario, world):
        agents = world.policy_agents
        self.scenario = scenario
        self.n_agents = A = len(agents)
        self.agent_i = [a.index for a in agents]
        self.goal_i = [a.goal.index for a in agents]
        self.goal_r = [float(a.goal.shape.radius) for a in agents]
        self.done_r = [float(a.shape.radius) for a in agents]
        self.factor = float(scenario.pos_shaping_factor)
        self.final = float(scenario.final_reward)
        self.coll_pen = float(scenario.agent_collision_penalty)
        self.min_coll = float(scenario.min_collision_distance)
        self.shared = bool(scenario.shared_rew)
        self.all_goals = bool(scenario.observe_all_goals)
        self.lidar_on = bool(scenario.collisions)
        # (i, j), i > j, in the JAX package's loop order
        self.pairs = [(i, j) for i in range(A) for j in range(A) if i > j and world.collides(agents[i], agents[j])]
        self.obs_w = 4 + 2 * (A if self.all_goals else 1)
        self.base = A * self.obs_w
        self.n_scratch_in = A
        self.n_out = self.base + 3 * A + 2
        self.carry_extra_idx = tuple(range(self.base + 2 * A, self.base + 3 * A))
        self.unpack_reads = ("state",) if self.lidar_on else ()
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["pos_shaping"].T  # [A, B]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        prev = ctx["scratch"]
        A = self.n_agents
        goal_rel = [(px[a] - px[g], py[a] - py[g]) for a, g in zip(self.agent_i, self.goal_i)]
        dist = [F._norm(gx, gy) for gx, gy in goal_rel]
        shaping = [d * self.factor for d in dist]
        per_agent = [prev[i] - shaping[i] for i in range(A)]
        all_reached = None
        for i in range(A):
            og = dist[i] < self.goal_r[i]
            all_reached = og if all_reached is None else (all_reached & og)
        final_rew = torch.where(all_reached, self.final, 0.0)

        coll = [torch.zeros_like(px[0]) for _ in range(A)]
        for i, j in self.pairs:
            ai, aj = self.agent_i[i], self.agent_i[j]
            d = F._norm(px[ai] - px[aj], py[ai] - py[aj]) - self.done_r[i] - self.done_r[j]
            hit = (d <= self.min_coll).to(torch.float32) * self.coll_pen
            coll[i] = coll[i] + hit
            coll[j] = coll[j] + hit

        done = None
        for i in range(A):
            d_ok = dist[i] < self.done_r[i]
            done = d_ok if done is None else (done & d_ok)

        rows = []
        for i, a in enumerate(self.agent_i):
            rows += [px[a], py[a], vx[a], vy[a]]
            if self.all_goals:
                for g in self.goal_i:
                    rows += [px[a] - px[g], py[a] - py[g]]
            else:
                rows += list(goal_rel[i])
        return rows + per_agent + coll + shaping + [final_rew, done.to(torch.float32)]

    def unpack(self, extra, state):
        """Output rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading axis passes through where the Lidar is off (with
        it on, ``state`` is each env's, ``extra`` [n_out, B])."""
        A, w, base = self.n_agents, self.obs_w, self.base
        row = lambda r: extra[..., r, :]
        cols = lambda lo, hi: extra[..., lo:hi, :].transpose(-1, -2)
        per_agent_rows = [row(base + i) for i in range(A)]
        pos_rew = _row_sum(per_agent_rows)
        final_rew = row(base + 3 * A)
        obs = []
        for i, a in enumerate(self.scenario.world.policy_agents):
            parts = [cols(i * w, (i + 1) * w)]
            if self.lidar_on:
                parts.append(a.sensors[0].max_range - a.sensors[0].measure(state))
            obs.append(torch.cat(parts, dim=-1))
        rews = tuple(
            (pos_rew if self.shared else per_agent_rows[i]) + final_rew + row(base + A + i) for i in range(A)
        )
        updates = {
            "pos_shaping": cols(base + 2 * A, base + 3 * A),
            "pos_rew_per_agent": cols(base, base + A),
            "pos_rew": pos_rew,
            "final_rew": final_rew,
            "collision_rew": cols(base + A, base + 2 * A),
        }
        return tuple(obs), rews, row(base + 3 * A + 1) > 0.5, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A or self.n_scratch_in > K.MAX_K:
                raise NotImplementedError(f"the fused kernel's navigation emit takes at most {K.MAX_K} agents")
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = ei
            p = ep.navigation
            p.n_agents = self.n_agents
            for i in range(self.n_agents):
                p.agent[i], p.goal[i] = self.agent_i[i], self.goal_i[i]
                p.goal_r[i], p.done_r[i] = self.goal_r[i], self.done_r[i]
            for i, j in self.pairs:
                p.pair_mask[i] |= 1 << j
            p.factor, p.final, p.coll_pen, p.min_coll = self.factor, self.final, self.coll_pen, self.min_coll
            p.all_goals = self.all_goals
            self._kernel_emit = (K.EMIT_NAVIGATION, ep)
        return self._kernel_emit


class HeuristicPolicy(BaseHeuristicPolicy):
    """The JAX package's CLF-QP goal-seeking controller:

        minimize  |u|^2 + clf_slack * s^2
        s.t.      -u_range <= u <= u_range
                  LfV + LgV . u + clf_epsilon * V + s <= 0

    with V = |p - g|^2 + 0.5 (p - g) . v + |v|^2. With one inequality and a
    box, the optimum is one-dimensional in the dual multiplier lambda:
    u(lambda) = clip(-lambda LgV / 2, -r, r), s(lambda) = -lambda / (2w), and
    the residual a + LgV . u(lambda) + s(lambda) (a = LfV + epsilon V)
    decreases strictly in lambda, so 60 steps of bisection find its root."""

    def __init__(self, *args, clf_epsilon=0.2, clf_slack=100.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.clf_epsilon = clf_epsilon
        self.clf_slack = clf_slack

    def compute_action(self, observation, u_range):
        # obs layout: pos (2), vel (2), pos - goal (2), ...
        vel = observation[:, 2:4]
        rel = observation[:, 4:6]
        V = (rel[:, 0] ** 2 + 0.5 * rel[:, 0] * vel[:, 0] + vel[:, 0] ** 2
             + rel[:, 1] ** 2 + 0.5 * rel[:, 1] * vel[:, 1] + vel[:, 1] ** 2)
        LfV = (2 * rel[:, 0] + vel[:, 0]) * vel[:, 0] + (2 * rel[:, 1] + vel[:, 1]) * vel[:, 1]
        LgV = torch.stack([0.5 * rel[:, 0] + 2 * vel[:, 0], 0.5 * rel[:, 1] + 2 * vel[:, 1]], dim=1)
        a = LfV + self.clf_epsilon * V
        w = self.clf_slack
        r = u_range

        def u_of(lam):
            return torch.clamp(-lam[:, None] * LgV / 2.0, -r, r)

        def resid(lam):
            # LgV . u(lambda) <= 0 for lambda >= 0, so resid(hi) <= a -
            # hi / (2w) < 0 at hi = 2w(|a| + 1): the root is bracketed
            # wherever a > 0
            return a + torch.sum(LgV * u_of(lam), dim=1) - lam / (2.0 * w)

        lo = torch.zeros_like(a)
        hi = 2.0 * w * (torch.abs(a) + 1.0)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            pos = resid(mid) > 0
            lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
        lam = 0.5 * (lo + hi)
        # the constraint holds at u = 0 where a <= 0: lambda 0, u 0
        lam = torch.where(a <= 0, torch.zeros_like(lam), lam)
        return u_of(lam)
