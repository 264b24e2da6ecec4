"""Balance: N agents carry a line with a heavy sphere package on top,
against gravity, toward a goal; the line or the package touching the floor
ends the episode with a penalty.

Counterpart of vmas_tpu/scenarios/balance.py. Its world drives the
line-sphere, box-sphere, box-line and sphere-sphere contacts and static
world gravity; its outputs come out of the fused step as rows
(``BalanceOutputs``). ``HeuristicPolicy`` is the JAX package's scripted
policy.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Box, Color, Landmark, Line, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import LINE_MIN_DIST, Y, safe_norm
from vmas_tpu_torch.scenario import BaseHeuristicPolicy, BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 3)
        self.package_mass = kwargs.pop("package_mass", 5)
        self.random_package_pos_on_line = kwargs.pop("random_package_pos_on_line", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        # the viewer's settings (render/viewer.py)
        self.visualize_semidims = False
        assert self.n_agents > 1

        self.line_length = 0.8
        self.agent_radius = 0.03
        self.shaping_factor = 100
        self.fall_reward = -10

        world = World(batch_dim, device, gravity=(0.0, -0.05), y_semidim=1)
        for i in range(self.n_agents):
            world.add_agent(Agent(name=f"agent_{i}", shape=Sphere(self.agent_radius), u_multiplier=0.7))
        self.goal = Landmark(name="goal", collide=False, shape=Sphere(), color=Color.LIGHT_GREEN)
        world.add_landmark(self.goal)
        self.package = Landmark(
            name="package", collide=True, movable=True, shape=Sphere(),
            mass=self.package_mass, color=Color.RED,
        )
        self.package.goal = self.goal
        world.add_landmark(self.package)
        self.line = Landmark(
            name="line", shape=Line(length=self.line_length), collide=True,
            movable=True, rotatable=True, mass=5, color=Color.BLACK,
        )
        world.add_landmark(self.line)
        self.floor = Landmark(name="floor", collide=True, shape=Box(length=10, width=1), color=Color.WHITE)
        world.add_landmark(self.floor)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        ysd = self.world.y_semidim

        def uniform(lo, hi):
            return torch.rand((B,), generator=generator, device=dev) * (hi - lo) + lo

        goal_pos = torch.stack([uniform(-1.0, 1.0), uniform(0.0, ysd)], dim=-1)
        line_x = uniform(-1.0 + self.line_length / 2, 1.0 - self.line_length / 2)
        line_pos = torch.stack([line_x, torch.full((B,), -ysd + self.agent_radius * 2, device=dev)], dim=-1)
        r = self.package.shape.radius
        if self.random_package_pos_on_line:
            rel_x = uniform(-self.line_length / 2 + r, self.line_length / 2 - r)
        else:
            rel_x = torch.zeros((B,), device=dev)
        package_rel = torch.stack([rel_x, torch.full((B,), r, device=dev)], dim=-1)

        for i, agent in enumerate(self.world.agents):
            offset = torch.tensor(
                [
                    -(self.line_length - agent.shape.radius) / 2
                    + i * (self.line_length - agent.shape.radius) / (self.n_agents - 1),
                    -self.agent_radius * 2,
                ],
                dtype=torch.float32, device=dev,
            )
            state = agent.set_pos(state, line_pos + offset[None])

        state = self.line.set_pos(state, line_pos)
        state = self.goal.set_pos(state, goal_pos)
        state = self.package.set_pos(state, line_pos + package_rel)
        state = self.floor.set_pos(
            state,
            torch.tensor([0.0, -ysd - self.floor.shape.width / 2 - self.agent_radius],
                         dtype=torch.float32, device=dev),
        )

        scratch = dict(state.scenario)
        scratch["on_the_ground"] = self._compute_on_the_ground(state)
        scratch["global_shaping"] = safe_norm(self.package.pos(state) - self.goal.pos(state)) * self.shaping_factor
        scratch["pos_rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch["ground_rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def _compute_on_the_ground(self, state):
        return self.world.is_overlapping(state, self.line, self.floor) | self.world.is_overlapping(
            state, self.package, self.floor
        )

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        on_ground = self._compute_on_the_ground(state)
        package_dist = safe_norm(self.package.pos(state) - self.goal.pos(state))
        scratch["on_the_ground"] = on_ground
        scratch["ground_rew"] = torch.where(
            on_ground, torch.full_like(package_dist, float(self.fall_reward)), torch.zeros_like(package_dist)
        )
        global_shaping = package_dist * self.shaping_factor
        scratch["pos_rew"] = scratch["global_shaping"] - global_shaping
        scratch["global_shaping"] = global_shaping
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["ground_rew"] + state.scenario["pos_rew"]

    def observation(self, agent, state):
        return torch.cat(
            [
                agent.pos(state),
                agent.vel(state),
                agent.pos(state) - self.package.pos(state),
                agent.pos(state) - self.line.pos(state),
                self.package.pos(state) - self.goal.pos(state),
                self.package.vel(state),
                self.line.vel(state),
                self.line.ang_vel(state)[:, None],
                torch.remainder(self.line.rot(state), math.pi)[:, None],
            ],
            dim=-1,
        )

    def done(self, state):
        return state.scenario["on_the_ground"] | self.world.is_overlapping(state, self.package, self.goal)

    def info(self, agent, state):
        return {"pos_rew": state.scenario["pos_rew"], "ground_rew": state.scenario["ground_rew"]}

    def make_fused_outputs(self, world):
        return BalanceOutputs(self, world)


class BalanceOutputs(F.FusedOutputs):
    """Balance's observations, reward and done as extra rows of the fused
    step. ``emit`` mirrors pre_rewards/observation/done line for line (the
    plain version); the kernel's BalanceEmit computes the same rows on the
    device from the constants of ``kernel_emit``.

    Rows: per agent pos, vel, pos - package, pos - line (8); then the shared
    package - goal, package vel, line vel, line angular velocity and the
    line's rotation mod pi (8); then pos_rew, ground_rew, on_ground, done
    and the new shaping (5)."""

    agent_w = 8
    shared_w = 8
    n_scratch_in = 1  # the previous global_shaping

    def __init__(self, scenario, world):
        self.agent_i = [a.index for a in world.policy_agents]
        self.n_agents = A = len(self.agent_i)
        self.goal_i = scenario.goal.index
        self.pkg_i = scenario.package.index
        self.line_i = scenario.line.index
        self.floor_i = scenario.floor.index
        self.pkg_r = float(scenario.package.shape.radius)
        self.goal_r = float(scenario.goal.shape.radius)
        self.line_half = scenario.line.shape.length / 2
        self.floor_hw = scenario.floor.shape.width / 2
        self.floor_hl = scenario.floor.shape.length / 2
        self.factor = float(scenario.shaping_factor)
        self.fall_rew = float(scenario.fall_reward)
        self.base = A * self.agent_w + self.shared_w
        self.n_out = self.base + 5
        # rows-carried rollout: the next step's scratch input is this step's
        # emitted shaping row
        self.carry_extra_idx = (self.base + 4,)
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["global_shaping"][None]  # [1, B]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rot, w = ctx["rot"], ctx["w"]
        prev = ctx["scratch"][0]
        fi, pi, li, gi = self.floor_i, self.pkg_i, self.line_i, self.goal_i

        fx, fy = px[fi], py[fi]
        fcos, fsin = torch.cos(rot[fi]), torch.sin(rot[fi])
        # line-floor overlap: box-line distance < 0 (queries.get_distance)
        bx, by, lx, ly = F._closest_line_box(
            fx, fy, fcos, fsin, self.floor_hw, self.floor_hl,
            px[li], py[li], torch.cos(rot[li]), torch.sin(rot[li]), self.line_half,
        )
        line_floor = F._norm(bx - lx, by - ly) - LINE_MIN_DIST < 0
        # package-floor overlap: the box-sphere branch of queries.is_overlapping
        cx, cy = F._closest_point_box(fx, fy, fcos, fsin, self.floor_hw, self.floor_hl, px[pi], py[pi])
        d_sphere_closest = F._norm(px[pi] - cx, py[pi] - cy)
        d_sphere_box = F._norm(px[pi] - fx, py[pi] - fy)
        d_closest_box = F._norm(fx - cx, fy - cy)
        pkg_floor = (d_sphere_box < d_closest_box) | (d_sphere_closest < self.pkg_r + LINE_MIN_DIST)
        on_ground = line_floor | pkg_floor

        dgx, dgy = px[pi] - px[gi], py[pi] - py[gi]
        package_dist = F._norm(dgx, dgy)
        shaping = package_dist * self.factor
        pos_rew = prev - shaping
        ground_rew = torch.where(on_ground, self.fall_rew, 0.0)
        # package-goal overlap: sphere-sphere distance < 0
        pkg_goal = package_dist - self.pkg_r - self.goal_r < 0
        done = on_ground | pkg_goal

        rows = []
        for ai in self.agent_i:
            rows += [
                px[ai], py[ai], vx[ai], vy[ai],
                px[ai] - px[pi], py[ai] - py[pi],
                px[ai] - px[li], py[ai] - py[li],
            ]
        rows += [dgx, dgy, vx[pi], vy[pi], vx[li], vy[li], w[li], torch.remainder(rot[li], math.pi)]
        rows += [pos_rew, ground_rew, on_ground.to(torch.float32), done.to(torch.float32), shaping]
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through."""
        A, w, base = self.n_agents, self.agent_w, self.base
        shared = extra[..., A * w:base, :].transpose(-1, -2)
        obs = tuple(
            torch.cat([extra[..., i * w:(i + 1) * w, :].transpose(-1, -2), shared], dim=-1) for i in range(A)
        )
        pos_rew = extra[..., base, :]
        ground_rew = extra[..., base + 1, :]
        on_ground = extra[..., base + 2, :] > 0.5
        done = extra[..., base + 3, :] > 0.5
        shaping = extra[..., base + 4, :]
        rew = ground_rew + pos_rew
        rews = tuple(rew for _ in range(A))
        updates = {
            "on_the_ground": on_ground,
            "global_shaping": shaping,
            "pos_rew": pos_rew,
            "ground_rew": ground_rew,
        }
        return obs, rews, done, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A:
                raise NotImplementedError(f"the fused kernel's balance emit takes at most {K.MAX_A} agents")
            ep = K.EmitParams()
            ep.carry_idx[0] = self.carry_extra_idx[0]
            p = ep.balance
            p.n_agents = self.n_agents
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            p.goal, p.pkg, p.line, p.floor = self.goal_i, self.pkg_i, self.line_i, self.floor_i
            p.pkg_r, p.goal_r = self.pkg_r, self.goal_r
            p.pkg_dmin = self.pkg_r + LINE_MIN_DIST
            p.line_half, p.floor_hw, p.floor_hl = self.line_half, self.floor_hw, self.floor_hl
            p.factor, p.fall_rew = self.factor, self.fall_rew
            self._kernel_emit = (K.EMIT_BALANCE, ep)
        return self._kernel_emit


class HeuristicPolicy(BaseHeuristicPolicy):
    """The JAX package's balance policy: push up while the package is below
    the goal, else hold."""

    def compute_action(self, observation, u_range):
        B = observation.shape[0]
        dist_package_goal = observation[:, 8:10]
        y_ge_0 = dist_package_goal[:, Y] >= 0
        if self.continuous_actions:
            action = torch.clamp(
                torch.stack([torch.zeros(B, device=observation.device), -dist_package_goal[:, Y]], dim=1),
                -u_range, u_range,
            )
            action[:, Y] = torch.where(y_ge_0, 0.0, action[:, Y])
            return action
        return torch.where(y_ge_0, 0, 4)
