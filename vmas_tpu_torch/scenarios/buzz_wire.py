"""Buzz wire: two agents joined to a ball guide it down a wire maze to a
goal without touching the wire.

Counterpart of vmas_tpu/scenarios/buzz_wire.py. Its world drives two joints
(each agent to the ball, a bar of half the agent spacing between them), the
line-sphere contacts of the agents and the ball on the two walls and two
floors, and 15 substeps; its outputs come out of the fused step as rows
(``BuzzWireOutputs``), the 12 line-sphere overlap tests of the collision
penalty among them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Joint, Landmark, Line, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import LINE_MIN_DIST, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.random_start_angle = kwargs.pop("random_start_angle", True)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.collision_reward = kwargs.pop("collision_reward", -10)
        self.max_speed_1 = kwargs.pop("max_speed_1", None)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        # as the JAX package: the shaping factor is fixed at 1
        self.pos_shaping_factor = 1
        self.n_agents = 2
        self.wall_length = 2
        self.agent_spacing = 0.5
        self.agent_radius = 0.03
        self.ball_radius = self.agent_radius

        world = World(batch_dim, device, substeps=15, joint_force=900, collision_force=1500)
        world.add_agent(Agent(name="agent_0", shape=Sphere(self.agent_radius), u_multiplier=1, mass=1))
        world.add_agent(
            Agent(name="agent_1", shape=Sphere(self.agent_radius), u_multiplier=1, mass=1, max_speed=self.max_speed_1)
        )
        self.goal = Landmark(name="goal", shape=Sphere(radius=self.ball_radius), collide=False, color=Color.GREEN)
        world.add_landmark(self.goal)
        self.ball = Landmark(name="ball", shape=Sphere(radius=self.ball_radius), collide=True, movable=True)
        world.add_landmark(self.ball)
        for i in range(2):
            world.add_joint(
                Joint(
                    world.agents[i], self.ball, anchor_a=(0, 0), anchor_b=(0, 0), dist=self.agent_spacing / 2,
                    rotate_a=True, rotate_b=True, collidable=False, width=0, mass=1,
                )
            )
        self.walls = []
        for i in range(2):
            w = Landmark(name=f"wall {i}", collide=True, shape=Line(length=self.wall_length), color=Color.BLACK)
            self.walls.append(w)
            world.add_landmark(w)
        self.floors = []
        for i in range(2):
            f = Landmark(name=f"floor {i}", collide=True, shape=Line(length=self.agent_spacing / 2),
                         color=Color.BLACK)
            self.floors.append(f)
            world.add_landmark(f)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        lim = math.pi / 2 - math.pi / 3 if self.random_start_angle else 0.0
        start_angle = torch.rand((B,), generator=generator, device=dev) * (2 * lim) - lim
        dx = (self.agent_spacing / 2) * torch.cos(start_angle)
        dy = (self.agent_spacing / 2) * torch.sin(start_angle)

        min_x, max_x = -self.agent_radius, self.agent_radius
        min_y = -self.wall_length / 2 + 2 * self.agent_radius
        max_y = -self.agent_radius
        r = torch.rand((B, 2), generator=generator, device=dev)
        ball_pos = torch.stack([(min_x - max_x) * r[:, 0] + max_x, (min_y - max_y) * r[:, 1] + max_y], dim=-1)
        rg = torch.rand((B, 2), generator=generator, device=dev)
        goal_pos = torch.stack([(min_x - max_x) * rg[:, 0] + max_x, (-min_y + max_x) * rg[:, 1] - max_x], dim=-1)
        state = self.goal.set_pos(state, goal_pos)
        state = self.ball.set_pos(state, ball_pos)
        delta = torch.stack([dx, dy], dim=-1)
        for i, agent in enumerate(self.world.agents):
            state = agent.set_pos(state, ball_pos + delta * (-1 if i == 0 else 1))
        for i, wall in enumerate(self.walls):
            x = (self.agent_spacing / 4) * (-1 if i == 0 else 1)
            state = wall.set_pos(state, torch.tensor([x, 0.0], dtype=torch.float32, device=dev))
            state = wall.set_rot(state, torch.tensor(math.pi / 2, dtype=torch.float32, device=dev))
        for i, floor in enumerate(self.floors):
            y = (self.wall_length / 2) * (-1 if i == 0 else 1)
            state = floor.set_pos(state, torch.tensor([0.0, y], dtype=torch.float32, device=dev))

        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch = dict(state.scenario)
        scratch["pos_shaping"] = safe_norm(ball_pos - goal_pos) * self.pos_shaping_factor
        scratch["collided"] = torch.zeros((B,), dtype=torch.bool, device=dev)
        scratch["pos_rew"] = zeros
        scratch["collision_rew"] = zeros
        scratch["rew"] = zeros
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        B, dev = state.batch_dim, state.device
        dist = safe_norm(self.ball.pos(state) - self.goal.pos(state))
        pos_shaping = dist * self.pos_shaping_factor
        pos_rew = scratch["pos_shaping"] - pos_shaping
        scratch["pos_shaping"] = pos_shaping

        coll_rew = torch.zeros((B,), dtype=torch.float32, device=dev)
        collided = torch.zeros((B,), dtype=torch.bool, device=dev)
        for collidable in self.world.agents + [self.ball]:
            for entity in self.walls + self.floors:
                is_overlap = self.world.is_overlapping(state, collidable, entity)
                coll_rew = coll_rew + self.collision_reward * is_overlap.to(torch.float32)
                collided = collided | is_overlap
        scratch["pos_rew"] = pos_rew
        scratch["collision_rew"] = coll_rew
        scratch["collided"] = collided
        scratch["rew"] = pos_rew + coll_rew
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["rew"]

    def observation(self, agent, state):
        return torch.cat([agent.pos(state), agent.vel(state), agent.pos(state) - self.goal.pos(state)], dim=-1)

    def done(self, state):
        return (safe_norm(self.ball.pos(state) - self.goal.pos(state)) <= 0.01) | state.scenario["collided"]

    def info(self, agent, state):
        return {"pos_rew": state.scenario["pos_rew"], "collision_rew": state.scenario["collision_rew"]}

    def make_fused_outputs(self, world):
        return BuzzWireOutputs(self, world)


class BuzzWireOutputs(F.FusedOutputs):
    """buzz_wire's observations, reward and done as extra rows of the fused
    step. ``emit`` mirrors the JAX package's emit row for row (the plain
    version): the ball's distance to the goal and its shaping, then the
    collision penalty over the agents and the ball (in that order) against
    the two walls and the two floors (in that order), each a line-sphere
    overlap test ``|p - closest| - LINE_MIN_DIST - r < 0`` (two f32
    subtractions, as the JAX package computes it); the kernel's BuzzWireEmit
    computes the same rows from the constants of ``kernel_emit``.

    Rows: per agent pos, vel, pos - goal (6); then rew, pos_rew,
    collision_rew, the new shaping, collided and done. Scratch in: the
    previous shaping, carried from its emit row."""

    obs_w = 6
    n_scratch_in = 1

    def __init__(self, scenario, world):
        self.agent_i = [a.index for a in world.policy_agents]
        self.n_agents = A = len(self.agent_i)
        self.ball_i, self.goal_i = scenario.ball.index, scenario.goal.index
        # the collidables (index, radius rounded to f32) and the lines
        # (index, half length)
        self.coll = [(a.index, float(np.float32(a.shape.radius))) for a in world.policy_agents]
        self.coll.append((self.ball_i, float(np.float32(scenario.ball.shape.radius))))
        self.lines = [(e.index, e.shape.length / 2) for e in scenario.walls + scenario.floors]
        self.factor = float(scenario.pos_shaping_factor)
        self.coll_pen = float(scenario.collision_reward)
        self.base = A * self.obs_w
        self.n_out = self.base + 6
        self.carry_extra_idx = (self.base + 3,)
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["pos_shaping"][None]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rot = ctx["rot"]
        prev = ctx["scratch"][0]
        bi, gi = self.ball_i, self.goal_i

        dist = F._norm(px[bi] - px[gi], py[bi] - py[gi])
        shaping = dist * self.factor
        pos_rew = prev - shaping

        trig = [(torch.cos(rot[li]), torch.sin(rot[li])) for li, _ in self.lines]
        coll_rew, collided = None, None
        for ci, r in self.coll:
            for (li, half), (c, s) in zip(self.lines, trig):
                cx, cy = F._closest_point_line(px[li], py[li], c, s, half, px[ci], py[ci])
                over = F._norm(px[ci] - cx, py[ci] - cy) - LINE_MIN_DIST - r < 0
                hit = over.to(torch.float32) * self.coll_pen
                coll_rew = hit if coll_rew is None else coll_rew + hit
                collided = over if collided is None else (collided | over)
        rew = pos_rew + coll_rew
        done = (dist <= 0.01) | collided

        rows = []
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai], px[ai] - px[gi], py[ai] - py[gi]]
        rows += [rew, pos_rew, coll_rew, shaping, collided.to(torch.float32), done.to(torch.float32)]
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through."""
        A, w, base = self.n_agents, self.obs_w, self.base
        row = lambda r: extra[..., r, :]
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        rew = row(base)
        updates = {
            "pos_shaping": row(base + 3), "pos_rew": row(base + 1), "collision_rew": row(base + 2),
            "collided": row(base + 4) > 0.5, "rew": rew,
        }
        return obs, tuple(rew for _ in range(A)), row(base + 5) > 0.5, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A or len(self.lines) > K.MAX_E:
                raise NotImplementedError(
                    f"the fused kernel's buzz_wire emit takes at most {K.MAX_A} agents and {K.MAX_E} lines"
                )
            ep = K.EmitParams()
            ep.carry_idx[0] = self.carry_extra_idx[0]
            p = ep.buzz_wire
            p.n_agents, p.ball, p.goal = self.n_agents, self.ball_i, self.goal_i
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            p.n_coll = len(self.coll)
            for k, (ci, r) in enumerate(self.coll):
                p.coll[k], p.coll_r[k] = ci, r
            p.n_lines = len(self.lines)
            for k, (li, half) in enumerate(self.lines):
                p.line[k], p.half[k] = li, half
            p.factor, p.coll_pen = self.factor, self.coll_pen
            self._kernel_emit = (K.EMIT_BUZZ_WIRE, ep)
        return self._kernel_emit
