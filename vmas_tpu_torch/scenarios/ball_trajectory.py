"""Ball trajectory: two agents joined to a ball drive it around a circle of
radius 0.5 at a desired speed.

Counterpart of vmas_tpu/scenarios/ball_trajectory.py. Its world drives two
joints (each agent to the ball), the sphere-sphere contacts of the three
bodies and 15 substeps; its outputs come out of the fused step as rows
(``BallTrajectoryOutputs``). As in the JAX package (and the original, whose
reward updates the shaping baselines on every per-agent call), the first
agent receives the shaping delta and the others zeros.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Joint, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import JOINT_FORCE, X, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 0)
        self.speed_shaping_factor = kwargs.pop("speed_shaping_factor", 1)
        self.dist_shaping_factor = kwargs.pop("dist_shaping_factor", 0)
        self.joints = kwargs.pop("joints", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.n_agents = 2
        self.desired_speed = 1
        self.desired_radius = 0.5
        self.agent_spacing = 0.4
        self.agent_radius = 0.03
        self.ball_radius = 2 * self.agent_radius

        world = World(
            batch_dim, device,
            substeps=15 if self.joints else 5,
            joint_force=900 if self.joints else JOINT_FORCE,
            collision_force=1500 if self.joints else 400,
            drag=0,
        )
        world.add_agent(Agent(name="agent_0", shape=Sphere(self.agent_radius), drag=0.25))
        world.add_agent(Agent(name="agent_1", shape=Sphere(self.agent_radius), drag=0.25))
        self.ball = Landmark(
            name="ball", shape=Sphere(radius=self.ball_radius), collide=True, movable=True, linear_friction=0.04,
        )
        world.add_landmark(self.ball)
        if self.joints:
            for i in range(self.n_agents):
                world.add_joint(
                    Joint(
                        world.agents[i], self.ball, anchor_a=(0, 0), anchor_b=(0, 0), dist=self.agent_spacing / 2,
                        rotate_a=True, rotate_b=True, collidable=False, width=0, mass=1,
                    )
                )
        return world

    def _closest_point_circle(self, pos):
        n = safe_norm(pos)[:, None]
        return torch.where(n == 0, 0.0, pos / torch.where(n == 0, 1.0, n)) * self.desired_radius

    def _shapings(self, state):
        ball_pos, ball_vel = self.ball.pos(state), self.ball.vel(state)
        pos_shaping = torch.sqrt(safe_norm(ball_pos - self._closest_point_circle(ball_pos))) * self.pos_shaping_factor
        speed_shaping = torch.abs(self.desired_speed - safe_norm(ball_vel)) * self.speed_shaping_factor
        dist_shaping = (
            torch.stack([safe_norm(a.pos(state) - ball_pos) for a in self.world.agents], dim=1).sum(1)
            * self.dist_shaping_factor
        )
        return pos_shaping, speed_shaping, dist_shaping

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        R = self.desired_radius
        ball_pos = torch.rand((B, 2), generator=generator, device=dev) * (2 * R) - R
        state = self.ball.set_pos(state, ball_pos)
        swap = torch.rand((B,), generator=generator, device=dev) < 0.5
        sign = torch.where(swap, 1.0, -1.0)
        for i, agent in enumerate(self.world.agents):
            offset = torch.zeros((B, 2), dtype=torch.float32, device=dev)
            offset[:, X] = (self.agent_spacing / 2) * sign * (-1 if i == 0 else 1)
            state = agent.set_pos(state, ball_pos + offset)

        pos_s, speed_s, dist_s = self._shapings(state)
        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch = dict(state.scenario)
        scratch["pos_shaping"] = pos_s
        scratch["speed_shaping"] = speed_s
        scratch["dist_shaping"] = dist_s
        scratch["pos_rew"] = zeros
        scratch["speed_rew"] = zeros
        scratch["dist_rew"] = zeros
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        pos_s, speed_s, dist_s = self._shapings(state)
        scratch["pos_rew"] = scratch["pos_shaping"] - pos_s
        scratch["speed_rew"] = scratch["speed_shaping"] - speed_s
        scratch["dist_rew"] = scratch["dist_shaping"] - dist_s
        scratch["pos_shaping"] = pos_s
        scratch["speed_shaping"] = speed_s
        scratch["dist_shaping"] = dist_s
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        delta = s["pos_rew"] + s["speed_rew"] + s["dist_rew"]
        # the agents after the first observe zero deltas (module docstring)
        return delta if agent.slot == 0 else torch.zeros_like(delta)

    def observation(self, agent, state):
        return torch.cat(
            [agent.pos(state), agent.vel(state), agent.pos(state) - self.ball.pos(state), agent.pos(state)], dim=-1
        )

    def info(self, agent, state):
        s = state.scenario
        return {"pos_rew": s["pos_rew"], "speed_rew": s["speed_rew"], "dist_rew": s["dist_rew"]}

    def make_fused_outputs(self, world):
        return BallTrajectoryOutputs(self, world)

    def extra_render(self, env, ax, env_index: int = 0):
        """The trajectory's goal circle."""
        from vmas_tpu_torch.render import draw

        draw.draw_circle(ax, (0.0, 0.0), self.desired_radius, (0, 0, 0))


class BallTrajectoryOutputs(F.FusedOutputs):
    """ball_trajectory's observations and rewards as extra rows of the fused
    step. ``emit`` mirrors the JAX package's emit row for row (the plain
    version): the ball's closest point on the circle (unit(pos) * R, zero
    at the centre), the square root of its distance to it (``** 0.5``,
    which XLA computes as a square root), the speed shaping and the sum of
    the agents' distances to the ball; the kernel's BallTrajectoryEmit
    computes the same rows from the constants of ``kernel_emit``.

    Rows: per agent pos, vel, pos - ball, pos (8); then pos_rew, speed_rew,
    dist_rew and the three new shapings. Scratch in: the pos, speed and
    dist shapings, each carried from its emit row."""

    obs_w = 8
    n_scratch_in = 3

    def __init__(self, scenario, world):
        self.agent_i = [a.index for a in world.policy_agents]
        self.n_agents = A = len(self.agent_i)
        self.ball_i = scenario.ball.index
        self.R = float(scenario.desired_radius)
        self.pos_f = float(scenario.pos_shaping_factor)
        self.speed_f = float(scenario.speed_shaping_factor)
        self.dist_f = float(scenario.dist_shaping_factor)
        self.v_des = float(scenario.desired_speed)
        self.base = A * self.obs_w
        self.n_out = self.base + 6
        self.carry_extra_idx = (self.base + 3, self.base + 4, self.base + 5)
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        s = state.scenario
        return torch.stack([s["pos_shaping"], s["speed_shaping"], s["dist_shaping"]])

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        pp, sp, dp = ctx["scratch"]
        bi = self.ball_i
        bx, by = px[bi], py[bi]

        n = F._norm(bx, by)
        den = torch.where(n == 0, 1.0, n)
        cx = torch.where(n == 0, 0.0, bx / den) * self.R
        cy = torch.where(n == 0, 0.0, by / den) * self.R
        pos_s = torch.sqrt(F._norm(bx - cx, by - cy)) * self.pos_f
        speed_s = torch.abs(self.v_des - F._norm(vx[bi], vy[bi])) * self.speed_f
        dist = None
        for ai in self.agent_i:
            d = F._norm(px[ai] - bx, py[ai] - by)
            dist = d if dist is None else dist + d
        dist_s = dist * self.dist_f

        rows = []
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai], px[ai] - bx, py[ai] - by, px[ai], py[ai]]
        rows += [pp - pos_s, sp - speed_s, dp - dist_s, pos_s, speed_s, dist_s]
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through."""
        A, w, base = self.n_agents, self.obs_w, self.base
        row = lambda r: extra[..., r, :]
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        pos_rew, speed_rew, dist_rew = row(base), row(base + 1), row(base + 2)
        delta = pos_rew + speed_rew + dist_rew
        rews = tuple(delta if i == 0 else torch.zeros_like(delta) for i in range(A))
        updates = {
            "pos_rew": pos_rew, "speed_rew": speed_rew, "dist_rew": dist_rew,
            "pos_shaping": row(base + 3), "speed_shaping": row(base + 4), "dist_shaping": row(base + 5),
        }
        return obs, rews, torch.zeros(delta.shape, dtype=torch.bool, device=delta.device), updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A:
                raise NotImplementedError(f"the fused kernel's ball_trajectory emit takes at most {K.MAX_A} agents")
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = ei
            p = ep.ball_trajectory
            p.n_agents, p.ball = self.n_agents, self.ball_i
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            p.R, p.pos_f, p.speed_f, p.dist_f, p.v_des = self.R, self.pos_f, self.speed_f, self.dist_f, self.v_des
            self._kernel_emit = (K.EMIT_BALL_TRAJECTORY, ep)
        return self._kernel_emit
