"""Passage: a cross of 5 agents must get through a wall of boxes with n open
passages to a mirrored cross of goals.

Counterpart of vmas_tpu/scenarios/passage.py: each env draws its own
arrangement of the agents in the cross and of the boxes along the wall (the
JAX package's per-env permutations), and the shared-reward mode's
penalties accumulate over the agents in order. Its world drives
sphere-sphere contacts among the agents and box-sphere contacts of the
agents on the wall (95 pairs at its defaults, 30 entities); its outputs
come out of the fused step as rows (``PassageOutputs``).
"""

from __future__ import annotations

import numpy as np
import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Box, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import LINE_MIN_DIST, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_passages = kwargs.pop("n_passages", 1)
        self.shared_reward = kwargs.pop("shared_reward", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        # the viewer's settings (render/viewer.py)
        self.visualize_semidims = False
        assert 1 <= self.n_passages <= 20

        self.shaping_factor = 100
        self.n_agents = 5
        self.agent_radius = 0.03333
        self.agent_spacing = 0.1
        self.passage_width = 0.2
        self.passage_length = 0.103

        world = World(batch_dim, device, x_semidim=1, y_semidim=1)
        for i in range(self.n_agents):
            agent = Agent(name=f"agent_{i}", shape=Sphere(self.agent_radius), u_multiplier=0.7)
            world.add_agent(agent)
            goal = Landmark(name=f"goal {i}", collide=False, shape=Sphere(radius=self.agent_radius),
                            color=Color.LIGHT_GREEN)
            agent.goal = goal
            world.add_landmark(goal)
        self.passages = []
        n_boxes = int((2 * world.x_semidim + 2 * self.agent_radius) // self.passage_length)
        for i in range(n_boxes):
            passage = Landmark(
                name=f"passage {i}", collide=i >= self.n_passages, movable=False,
                shape=Box(length=self.passage_length, width=self.passage_width), color=Color.RED,
                collision_filter=lambda e: not isinstance(e.shape, Box),
            )
            world.add_landmark(passage)
            self.passages.append(passage)
        return world

    @staticmethod
    def _offset(i, n, spacing):
        if i == n - 1:
            return (0.0, 0.0)
        x = 0.0 if i % 2 else (spacing if i == 0 else -spacing)
        y = 0.0 if not i % 2 else (spacing if i == 1 else -spacing)
        return (x, y)

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        rand = lambda *s: torch.rand(s, generator=generator, device=dev)
        m = 3 * self.agent_radius + self.agent_spacing
        lo, hi = -1 + m, 1 - m
        central_agent_pos = torch.stack(
            [lo + rand(B) * (hi - lo), lo + rand(B) * (-m - self.passage_width / 2 - lo)], dim=-1)
        g_lo = m + self.passage_width / 2
        central_goal_pos = torch.stack([lo + rand(B) * (hi - lo), g_lo + rand(B) * (hi - g_lo)], dim=-1)

        offsets = torch.tensor([self._offset(i, self.n_agents, self.agent_spacing) for i in range(self.n_agents)],
                               dtype=torch.float32, device=dev)  # [A, 2]
        perm = torch.argsort(rand(B, self.n_agents), dim=1)  # [B, A]: each env's slot per agent
        agent_offsets = offsets[perm]  # [B, A, 2]

        shaping = []
        for i, agent in enumerate(self.world.agents):
            state = agent.set_pos(state, central_agent_pos + agent_offsets[:, i])
            state = agent.goal.set_pos(state, central_goal_pos + agent_offsets[:, i])
            shaping.append(safe_norm(agent.pos(state) - agent.goal.pos(state)) * self.shaping_factor)

        # each env's arrangement of the boxes along the wall
        n_boxes = len(self.passages)
        slot_x = (-1 - self.agent_radius + self.passage_length / 2
                  + self.passage_length * torch.arange(n_boxes, dtype=torch.float32, device=dev))
        pperm = torch.argsort(rand(B, n_boxes), dim=1)
        for i, passage in enumerate(self.passages):
            x = slot_x[pperm[:, i]]
            state = passage.set_pos(state, torch.stack([x, torch.zeros_like(x)], dim=-1))
            if not passage.collide:
                state = passage.set_rendering(state, False)

        scratch = dict(state.scenario)
        scratch["global_shaping"] = torch.stack(shaping, dim=-1)  # [B, A]
        scratch["shaping_rew"] = torch.zeros((B, self.n_agents), dtype=torch.float32, device=dev)
        scratch["collision_pen"] = torch.zeros((B, self.n_agents), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        dist = torch.stack([safe_norm(a.pos(state) - a.goal.pos(state)) for a in self.world.agents], dim=-1)
        agent_shaping = dist * self.shaping_factor
        scratch["shaping_rew"] = scratch["global_shaping"] - agent_shaping  # [B, A]
        scratch["global_shaping"] = agent_shaping

        penalties = []
        for agent in self.world.agents:
            p = torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)
            if agent.collide:
                for a in self.world.agents:
                    if a is not agent:
                        p = p - 10.0 * self.world.is_overlapping(state, a, agent).to(torch.float32)
                for passage in self.passages:
                    if passage.collide:
                        p = p - 10.0 * self.world.is_overlapping(state, agent, passage).to(torch.float32)
            penalties.append(p)
        scratch["collision_pen"] = torch.stack(penalties, dim=-1)  # [B, A]
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        i = agent.slot
        if self.shared_reward:
            # the shared reward accumulates the penalties over the agents in
            # order, as the per-agent reward calls of the reference do
            return s["shaping_rew"].sum(-1) + torch.cumsum(s["collision_pen"], dim=-1)[:, i]
        return s["shaping_rew"][:, i] + s["collision_pen"][:, i]

    def observation(self, agent, state):
        passage_obs = [p.pos(state) - agent.pos(state) for p in self.passages if not p.collide]
        return torch.cat(
            [agent.pos(state), agent.vel(state), agent.goal.pos(state) - agent.pos(state), *passage_obs], dim=-1)

    def done(self, state):
        return torch.all(torch.stack(
            [safe_norm(a.pos(state) - a.goal.pos(state)) <= a.shape.radius / 2 for a in self.world.agents], dim=1,
        ), dim=1)

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return PassageOutputs(self, world)

    def extra_render(self, env, ax, env_index: int = 0):
        """The arena's perimeter."""
        from vmas_tpu_torch.render import draw

        draw.draw_perimeter(ax, 1.0, pad=self.agent_radius)


class PassageOutputs(F.FusedOutputs):
    """Passage's observations, rewards and done as extra rows of the fused
    step: the agent-agent and agent-wall overlap tests of pre_rewards run
    in the kernel, and both reward modes are composed in ``unpack``.
    ``emit`` is the plain version; the kernel's PassageEmit computes the
    same rows from the constants of ``kernel_emit``.

    Rows: per agent pos, vel, goal - agent, each open passage - agent (6 +
    2 per open passage); then per agent the shaping reward, the collision
    penalty and the new shaping; then done. Scratch in: the previous
    shapings."""

    def __init__(self, scenario, world):
        agents = world.policy_agents
        self.agent_i = [a.index for a in agents]
        self.goal_i = [a.goal.index for a in agents]
        self.collide = [bool(a.collide) for a in agents]
        self.n_agents = A = len(agents)
        self.open_i = [p.index for p in scenario.passages if not p.collide]
        self.wall_i = [p.index for p in scenario.passages if p.collide]
        self.hw, self.hl = scenario.passage_width / 2, scenario.passage_length / 2
        radius = float(scenario.agent_radius)
        # the thresholds: the double expressions the JAX package compares
        # against, each rounded once to f32
        self.two_r = float(np.float32(2 * radius))
        self.wall_dmin = float(np.float32(radius + LINE_MIN_DIST))
        self.half_r = float(np.float32(radius / 2))
        self.factor = float(scenario.shaping_factor)
        self.shared = bool(scenario.shared_reward)
        self.obs_w = 6 + 2 * len(self.open_i)
        self.base = A * self.obs_w
        self.n_scratch_in = A  # the previous shapings
        self.n_out = self.base + 3 * A + 1
        # rows-carried rollout: the next step's scratch is this step's
        # emitted shaping rows, in agent order
        self.carry_extra_idx = tuple(range(self.base + 2 * A, self.base + 3 * A))
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["global_shaping"].T  # [A, B]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rot = ctx["rot"]
        prev = ctx["scratch"]
        A, ag = self.n_agents, self.agent_i

        goal_rel, dist = [], []
        for ai, gi in zip(ag, self.goal_i):
            gx, gy = px[gi] - px[ai], py[gi] - py[ai]
            goal_rel.append((gx, gy))
            dist.append(F._norm(gx, gy))
        shaping = [d * self.factor for d in dist]
        shaping_rew = [prev[i] - shaping[i] for i in range(A)]

        # the agent-agent overlaps, one test per pair (the lower agent first)
        aa = {}
        for i in range(A):
            for j in range(i + 1, A):
                d = F._norm(px[ag[i]] - px[ag[j]], py[ag[i]] - py[ag[j]]) - self.two_r
                aa[(i, j)] = (d < 0).to(torch.float32)
        # each agent's wall tests at once on [W, B] rows (every element sees
        # the kernel's ops for its wall), added in wall order
        if self.wall_i:
            wx, wy = torch.stack([px[w] for w in self.wall_i]), torch.stack([py[w] for w in self.wall_i])
            wr = torch.stack([rot[w] for w in self.wall_i])
            wcos, wsin = torch.cos(wr), torch.sin(wr)
        pen = []
        for i in range(A):
            p = None
            if self.collide[i]:
                for j in range(A):
                    if j != i:
                        hit = aa[(min(i, j), max(i, j))]
                        p = -10.0 * hit if p is None else p - 10.0 * hit
                if self.wall_i:
                    ax, ay = px[ag[i]], py[ag[i]]
                    cx, cy = F._closest_point_box(wx, wy, wcos, wsin, self.hw, self.hl, ax, ay)
                    d_sc = F._norm(ax - cx, ay - cy)
                    d_sb = F._norm(ax - wx, ay - wy)
                    d_cb = F._norm(wx - cx, wy - cy)
                    hits = ((d_sb < d_cb) | (d_sc < self.wall_dmin)).to(torch.float32)
                    for hit in hits:
                        p = -10.0 * hit if p is None else p - 10.0 * hit
            pen.append(p if p is not None else torch.zeros_like(px[0]))

        done = dist[0] <= self.half_r
        for d in dist[1:]:
            done = done & (d <= self.half_r)

        rows = []
        for i, ai in enumerate(ag):
            rows += [px[ai], py[ai], vx[ai], vy[ai], *goal_rel[i]]
            for oi in self.open_i:
                rows += [px[oi] - px[ai], py[oi] - py[ai]]
        rows += shaping_rew + pen + shaping
        rows.append(done.to(torch.float32))
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through. The shared mode's
        reward: the shaping rewards' sum plus the penalties accumulated over
        the agents in order, each summed in agent order from the first
        term."""
        A, w, base = self.n_agents, self.obs_w, self.base
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        sr = [extra[..., base + i, :] for i in range(A)]
        pen = [extra[..., base + A + i, :] for i in range(A)]
        done = extra[..., base + 3 * A, :] > 0.5
        if self.shared:
            total, cum, rews = sr[0], pen[0], [pen[0]]
            for i in range(1, A):
                total = total + sr[i]
                cum = cum + pen[i]
                rews.append(cum)
            rews = tuple(total + c for c in rews)
        else:
            rews = tuple(sr[i] + pen[i] for i in range(A))
        block = lambda k: extra[..., base + k * A:base + (k + 1) * A, :].transpose(-1, -2)
        updates = {"global_shaping": block(2), "shaping_rew": block(0), "collision_pen": block(1)}
        return obs, rews, done, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = int(ei)
            p = ep.passage
            p.n_agents, p.n_open, p.n_walls = self.n_agents, len(self.open_i), len(self.wall_i)
            for i in range(self.n_agents):
                p.agent[i], p.goal[i], p.collide[i] = self.agent_i[i], self.goal_i[i], self.collide[i]
            for k, oi in enumerate(self.open_i):
                p.open[k] = oi
            for k, wi in enumerate(self.wall_i):
                p.wall[k] = wi
            p.hw, p.hl, p.factor = self.hw, self.hl, self.factor
            p.two_r, p.wall_dmin, p.half_r = self.two_r, self.wall_dmin, self.half_r
            self._kernel_emit = (K.EMIT_PASSAGE, ep)
        return self._kernel_emit
