"""Ball passage: two agents push a ball through an opening in a wall of
boxes to a goal.

Counterpart of vmas_tpu/scenarios/ball_passage.py. Its world drives the
sphere-sphere contacts of the agents and the ball and the box-sphere
contacts of the three on the 19 walls; its outputs come out of the fused
step as rows (``BallPassageOutputs``), the 57 box-sphere overlap tests of
the collision penalty among them. The boxes' x-slots are permuted per env at
each reset.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Box, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import LINE_MIN_DIST, X, Y, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_passages = kwargs.pop("n_passages", 1)
        self.fixed_passage = kwargs.pop("fixed_passage", False)
        self.random_start_angle = kwargs.pop("random_start_angle", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        # the viewer's settings (render/viewer.py)
        self.visualize_semidims = False
        assert 1 <= self.n_passages <= 20

        self.pos_shaping_factor = 1
        self.collision_reward = -0.06
        self.n_agents = 2
        self.agent_spacing = 0.5
        self.agent_radius = 0.03333
        self.ball_radius = self.agent_radius
        self.passage_width = 0.2
        self.passage_length = 0.103

        world = World(batch_dim, device, x_semidim=1, y_semidim=1, drag=0, linear_friction=0.0)
        for i in range(2):
            world.add_agent(
                Agent(name=f"agent_{i}", shape=Sphere(self.agent_radius), u_multiplier=0.7, mass=2, drag=0.25)
            )
        self.goal = Landmark(name="goal", shape=Sphere(radius=self.ball_radius), collide=False, color=Color.GREEN)
        world.add_landmark(self.goal)
        self.ball = Landmark(
            name="ball", shape=Sphere(radius=self.ball_radius), collide=True, movable=True, mass=1,
            color=Color.BLACK, linear_friction=0.02,
        )
        world.add_landmark(self.ball)

        self.passages = []
        n_boxes = int((2 * world.x_semidim + 2 * self.agent_radius) // self.passage_length)

        def removed(i):
            return (n_boxes // 2) - self.n_passages / 2 <= i < (n_boxes // 2) + self.n_passages / 2

        for i in range(n_boxes):
            passage = Landmark(
                name=f"passage {i}", collide=not removed(i), movable=False,
                shape=Box(length=self.passage_length, width=self.passage_width), color=Color.RED,
                collision_filter=lambda e: not isinstance(e.shape, Box),
            )
            self.passages.append(passage)
            world.add_landmark(passage)
        return world

    def _open_passages(self):
        return [p for p in self.passages if not p.collide]

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        lim = math.pi / 2
        if self.random_start_angle:
            start_angle = torch.rand((B,), generator=generator, device=dev) * (2 * lim) - lim
        else:
            start_angle = torch.full((B,), -lim, dtype=torch.float32, device=dev)
        dx = (self.agent_spacing / 2) * torch.cos(start_angle)
        dy = (self.agent_spacing / 2) * torch.sin(start_angle)
        dxa, dya = torch.abs(dx), torch.abs(dy)

        min_x = -1 + (self.agent_radius + dxa)
        max_x = 1 - (self.agent_radius + dxa)
        min_y = -1 + (self.agent_radius + dya)
        max_y = -2 * self.agent_radius - self.passage_width / 2 - dya
        r = torch.rand((B, 2), generator=generator, device=dev)
        ball_pos = torch.stack([(min_x - max_x) * r[:, 0] + max_x, (min_y - max_y) * r[:, 1] + max_y], dim=-1)
        state = self.ball.set_pos(state, ball_pos)
        delta = torch.stack([dx, dy], dim=-1)
        state = self.world.agents[0].set_pos(state, ball_pos - delta)
        state = self.world.agents[1].set_pos(state, ball_pos + delta)

        min_xg, max_xg = -1 + self.agent_radius, 1 - self.agent_radius
        min_yg = 2 * self.agent_radius + self.passage_width / 2
        max_yg = 1 - self.agent_radius
        rg = torch.rand((B, 2), generator=generator, device=dev)
        goal_pos = torch.stack([(min_xg - max_xg) * rg[:, 0] + max_xg, (min_yg - max_yg) * rg[:, 1] + max_yg],
                               dim=-1)
        state = self.goal.set_pos(state, goal_pos)

        # the boxes' slots: a per-env permutation (a sort of uniform draws)
        n_boxes = len(self.passages)
        slot_x = (-1 - self.agent_radius + self.passage_length / 2
                  + self.passage_length * torch.arange(n_boxes, dtype=torch.float32, device=dev))
        if self.fixed_passage:
            perm = torch.arange(n_boxes, device=dev).expand(B, n_boxes)
        else:
            perm = torch.argsort(torch.rand((B, n_boxes), generator=generator, device=dev), dim=1)
        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
        for i, passage in enumerate(self.passages):
            state = passage.set_pos(state, torch.stack([slot_x[perm[:, i]], zeros], dim=-1))
            if not passage.collide:
                state = passage.set_rendering(state, False)

        scratch = dict(state.scenario)
        scratch["pos_shaping_pre"] = self._dist_to_open(state, ball_pos) * self.pos_shaping_factor
        scratch["pos_shaping_post"] = safe_norm(ball_pos - goal_pos) * self.pos_shaping_factor
        scratch["rew"] = zeros
        scratch["pos_rew"] = zeros
        scratch["collision_rew"] = zeros
        return state.replace(scenario=scratch)

    def _dist_to_open(self, state, ball_pos):
        """The ball's distance to the nearest open passage: [B]."""
        d = torch.stack([safe_norm(ball_pos - p.pos(state)) for p in self._open_passages()], dim=1)
        return d.min(dim=1).values

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        B, dev = state.batch_dim, state.device
        zero = torch.zeros((B,), dtype=torch.float32, device=dev)
        ball_pos = self.ball.pos(state)
        ball_passed = ball_pos[:, Y] > 0

        ball_shaping_pre = self._dist_to_open(state, ball_pos) * self.pos_shaping_factor
        pos_rew = torch.where(~ball_passed, scratch["pos_shaping_pre"] - ball_shaping_pre, zero)
        scratch["pos_shaping_pre"] = ball_shaping_pre

        ball_shaping_post = safe_norm(ball_pos - self.goal.pos(state)) * self.pos_shaping_factor
        pos_rew = pos_rew + torch.where(ball_passed, scratch["pos_shaping_post"] - ball_shaping_post, zero)
        scratch["pos_shaping_post"] = ball_shaping_post

        coll = zero
        walls = [p for p in self.passages if p.collide]
        for a in self.world.agents:
            for p in walls:
                coll = coll + self.collision_reward * self.world.is_overlapping(state, a, p).to(torch.float32)
        for p in walls:
            coll = coll + self.collision_reward * self.world.is_overlapping(state, p, self.ball).to(torch.float32)

        scratch["pos_rew"] = pos_rew
        scratch["collision_rew"] = coll
        scratch["rew"] = pos_rew + coll
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["rew"]

    def observation(self, agent, state):
        return torch.cat(
            [
                agent.pos(state),
                agent.vel(state),
                agent.pos(state) - self.goal.pos(state),
                agent.pos(state) - self.ball.pos(state),
                *[agent.pos(state) - p.pos(state) for p in self._open_passages()],
            ],
            dim=-1,
        )

    def done(self, state):
        ball_pos = self.ball.pos(state)
        return (
            (safe_norm(ball_pos - self.goal.pos(state)) <= 0.01)
            | (-1 + self.ball_radius >= ball_pos[:, X])
            | (ball_pos[:, X] >= 1 - self.ball_radius)
            | (-1 + self.ball_radius >= ball_pos[:, Y])
            | (ball_pos[:, Y] >= 1 - self.ball_radius)
        )

    def info(self, agent, state):
        return {"pos_rew": state.scenario["pos_rew"], "collision_rew": state.scenario["collision_rew"]}

    def make_fused_outputs(self, world):
        return BallPassageOutputs(self, world)

    def extra_render(self, env, ax, env_index: int = 0):
        """The arena's perimeter."""
        from vmas_tpu_torch.render import draw

        draw.draw_perimeter(ax, float(self.world.x_semidim), pad=self.agent_radius)


class BallPassageOutputs(F.FusedOutputs):
    """ball_passage's observations, reward and done as extra rows of the
    fused step. ``emit`` mirrors the JAX package's emit row for row (the
    plain version): the ball's distance to the nearest open passage and to
    the goal, each shaping taken on its side of the wall (``ball_passed``),
    the collision penalty over the agents' and then the ball's box-sphere
    overlap tests against each wall, in the JAX package's order, and the
    ball's out-of-arena done; the kernel's BallPassageEmit computes the same
    rows from the constants of ``kernel_emit``.

    Rows: per agent pos, vel, pos - goal, pos - ball, pos - each open
    passage (8 + 2 per open passage); then rew, pos_rew, collision_rew, the
    two new shapings and done. Scratch in: pos_shaping_pre and
    pos_shaping_post, each carried from its emit row."""

    n_scratch_in = 2

    def __init__(self, scenario, world):
        self.agent_i = [a.index for a in world.policy_agents]
        self.n_agents = A = len(self.agent_i)
        self.ball_i, self.goal_i = scenario.ball.index, scenario.goal.index
        self.open_i = [p.index for p in scenario.passages if not p.collide]
        self.wall_i = [p.index for p in scenario.passages if p.collide]
        # the collidables (agents, then the ball) and each one's contact
        # distance: radius + LINE_MIN_DIST, the double sum the JAX package
        # compares against, rounded once to f32
        colls = [(a.index, a.shape.radius) for a in world.policy_agents]
        colls.append((self.ball_i, scenario.ball.shape.radius))
        self.coll = [(ci, float(np.float32(r + LINE_MIN_DIST))) for ci, r in colls]
        self.hw, self.hl = scenario.passage_width / 2, scenario.passage_length / 2
        self.factor = float(scenario.pos_shaping_factor)
        self.coll_pen = float(scenario.collision_reward)
        # the arena bounds of done, each a double expression rounded once
        ball_r = float(scenario.ball_radius)
        self.lo, self.hi = float(np.float32(-1 + ball_r)), float(np.float32(1 - ball_r))
        self.obs_w = 8 + 2 * len(self.open_i)
        self.base = A * self.obs_w
        self.n_out = self.base + 6
        self.carry_extra_idx = (self.base + 3, self.base + 4)
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        s = state.scenario
        return torch.stack([s["pos_shaping_pre"], s["pos_shaping_post"]])

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rot = ctx["rot"]
        pp_pre, pp_post = ctx["scratch"]
        bi, gi = self.ball_i, self.goal_i

        ball_passed = py[bi] > 0
        dist_pass = None
        for pi in self.open_i:
            d = F._norm(px[bi] - px[pi], py[bi] - py[pi])
            dist_pass = d if dist_pass is None else torch.minimum(dist_pass, d)
        pre = dist_pass * self.factor
        pos_rew = torch.where(~ball_passed, pp_pre - pre, 0.0)
        dist_goal = F._norm(px[bi] - px[gi], py[bi] - py[gi])
        post = dist_goal * self.factor
        pos_rew = pos_rew + torch.where(ball_passed, pp_post - post, 0.0)

        # each collidable's wall tests at once on [W, B] rows (every element
        # sees the kernel's ops for its wall), added in wall order: the
        # agents x walls, then the ball x walls
        coll = None
        if self.wall_i:
            wx, wy = torch.stack([px[w] for w in self.wall_i]), torch.stack([py[w] for w in self.wall_i])
            wr = torch.stack([rot[w] for w in self.wall_i])
            wcos, wsin = torch.cos(wr), torch.sin(wr)
            for ci, dmin in self.coll:
                cx, cy = F._closest_point_box(wx, wy, wcos, wsin, self.hw, self.hl, px[ci], py[ci])
                d_sc = F._norm(px[ci] - cx, py[ci] - cy)
                d_sb = F._norm(px[ci] - wx, py[ci] - wy)
                d_cb = F._norm(wx - cx, wy - cy)
                hits = ((d_sb < d_cb) | (d_sc < dmin)).to(torch.float32) * self.coll_pen
                for hit in hits:
                    coll = hit if coll is None else coll + hit
        if coll is None:
            coll = torch.zeros_like(pos_rew)

        rew = pos_rew + coll
        done = ((dist_goal <= 0.01) | (self.lo >= px[bi]) | (px[bi] >= self.hi) | (self.lo >= py[bi])
                | (py[bi] >= self.hi))

        rows = []
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai], px[ai] - px[gi], py[ai] - py[gi], px[ai] - px[bi],
                     py[ai] - py[bi]]
            for pi in self.open_i:
                rows += [px[ai] - px[pi], py[ai] - py[pi]]
        rows += [rew, pos_rew, coll, pre, post, done.to(torch.float32)]
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through."""
        A, w, base = self.n_agents, self.obs_w, self.base
        row = lambda r: extra[..., r, :]
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        rew = row(base)
        updates = {
            "pos_shaping_pre": row(base + 3), "pos_shaping_post": row(base + 4), "pos_rew": row(base + 1),
            "collision_rew": row(base + 2), "rew": rew,
        }
        return obs, tuple(rew for _ in range(A)), row(base + 5) > 0.5, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if (self.n_agents > K.MAX_A or len(self.open_i) > K.MAX_E or len(self.wall_i) > K.MAX_E):
                raise NotImplementedError(
                    f"the fused kernel's ball_passage emit takes at most {K.MAX_A} agents and {K.MAX_E} open "
                    f"passages and walls"
                )
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = ei
            p = ep.ball_passage
            p.n_agents, p.ball, p.goal = self.n_agents, self.ball_i, self.goal_i
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            p.n_coll = len(self.coll)
            for k, (ci, dmin) in enumerate(self.coll):
                p.coll[k], p.coll_dmin[k] = ci, dmin
            p.n_open, p.n_walls = len(self.open_i), len(self.wall_i)
            for k, pi in enumerate(self.open_i):
                p.open[k] = pi
            for k, wi in enumerate(self.wall_i):
                p.wall[k] = wi
            p.hw, p.hl, p.factor, p.coll_pen = self.hw, self.hl, self.factor, self.coll_pen
            p.lo, p.hi = self.lo, self.hi
            self._kernel_emit = (K.EMIT_BALL_PASSAGE, ep)
        return self._kernel_emit
