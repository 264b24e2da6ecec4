"""Reverse transport: N agents spawn inside a hollow box package and push it
from within onto a goal; dense shaping reward.

Counterpart of vmas_tpu/scenarios/reverse_transport.py. Its world drives
sphere-sphere contacts among the agents and box-sphere contacts of the
agents on the hollow package's inner walls, over 5 substeps; its outputs
come out of the fused step as rows (``ReverseTransportOutputs``).
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
        n_agents = kwargs.pop("n_agents", 4)
        self.package_width = kwargs.pop("package_width", 0.6)
        self.package_length = kwargs.pop("package_length", 0.6)
        self.package_mass = kwargs.pop("package_mass", 50)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.shaping_factor = 100
        world = World(batch_dim, device, contact_margin=6e-3, substeps=5, collision_force=500)
        for i in range(n_agents):
            world.add_agent(Agent(name=f"agent_{i}", shape=Sphere(0.03), u_multiplier=0.5))
        self.goal = Landmark(name="goal", collide=False, shape=Sphere(radius=0.09), color=Color.LIGHT_GREEN)
        world.add_landmark(self.goal)
        self.package = Landmark(
            name=f"package {n_agents - 1}", collide=True, movable=True, mass=self.package_mass,
            shape=Box(length=self.package_length, width=self.package_width, hollow=True), color=Color.RED,
        )
        self.package.goal = self.goal
        world.add_landmark(self.package)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        rand = lambda *s: torch.rand(s, generator=generator, device=dev)
        package_pos = rand(B, 2) * 2 - 1
        state = self.package.set_pos(state, package_pos)
        for agent in self.world.agents:
            r = agent.shape.radius
            hx, hy = self.package_length / 2 - r, self.package_width / 2 - r
            rel = torch.stack([(rand(B) * 2 - 1) * hx, (rand(B) * 2 - 1) * hy], dim=-1)
            state = agent.set_pos(state, rel + package_pos)
        state = self.goal.set_pos(state, rand(B, 2) * 2 - 1)
        scratch = dict(state.scenario)
        scratch["global_shaping"] = safe_norm(self.package.pos(state) - self.goal.pos(state)) * self.shaping_factor
        scratch["on_goal"] = torch.zeros((B,), dtype=torch.bool, device=dev)
        scratch["rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        dist = safe_norm(self.package.pos(state) - self.goal.pos(state))
        on_goal = self.world.is_overlapping(state, self.package, self.goal)
        package_shaping = dist * self.shaping_factor
        scratch["rew"] = torch.where(~on_goal, scratch["global_shaping"] - package_shaping, 0.0)
        scratch["global_shaping"] = package_shaping
        scratch["on_goal"] = on_goal
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["rew"]

    def observation(self, agent, state):
        return torch.cat(
            [
                agent.pos(state),
                agent.vel(state),
                self.package.vel(state),
                self.package.pos(state) - agent.pos(state),
                self.package.pos(state) - self.goal.pos(state),
            ],
            dim=-1,
        )

    def done(self, state):
        return state.scenario["on_goal"]

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return ReverseTransportOutputs(self, world)


class ReverseTransportOutputs(F.FusedOutputs):
    """Reverse transport's observations, reward and done as extra rows of the
    fused step. ``emit`` mirrors pre_rewards/observation/done line for line
    (the plain version); the kernel's ReverseTransportEmit computes the same
    rows from the constants of ``kernel_emit``.

    Rows: per agent pos, vel, package vel, package - agent, package - goal
    (10); then the reward, on_goal and the new shaping."""

    obs_w = 10
    n_scratch_in = 1  # the previous global_shaping

    def __init__(self, scenario, world):
        self.agent_i = [a.index for a in world.policy_agents]
        self.n_agents = A = len(self.agent_i)
        self.goal_i = scenario.goal.index
        self.pkg_i = scenario.package.index
        self.pkg_hw = scenario.package.shape.width / 2
        self.pkg_hl = scenario.package.shape.length / 2
        # the on-goal test's threshold: the JAX package compares against
        # the double sum radius + LINE_MIN_DIST, rounded once to f32
        self.og_dmin = float(np.float32(float(scenario.goal.shape.radius) + LINE_MIN_DIST))
        self.factor = float(scenario.shaping_factor)
        self.base = A * self.obs_w
        self.n_out = self.base + 3
        # rows-carried rollout: the next step's scratch is this step's
        # emitted shaping row
        self.carry_extra_idx = (self.base + 2,)
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["global_shaping"][None]  # [1, B]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rot = ctx["rot"]
        prev = ctx["scratch"][0]
        pi, gx, gy = self.pkg_i, px[self.goal_i], py[self.goal_i]

        dx, dy = px[pi] - gx, py[pi] - gy
        dist = F._norm(dx, dy)
        # is_overlapping box-sphere (queries.is_overlapping)
        cx, cy = F._closest_point_box(px[pi], py[pi], torch.cos(rot[pi]), torch.sin(rot[pi]), self.pkg_hw,
                                      self.pkg_hl, gx, gy)
        d_sphere_closest = F._norm(gx - cx, gy - cy)
        d_closest_box = F._norm(px[pi] - cx, py[pi] - cy)
        on_goal = (dist < d_closest_box) | (d_sphere_closest < self.og_dmin)
        shaping = dist * self.factor
        rew = torch.where(on_goal, 0.0, prev - shaping)

        rows = []
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai], vx[pi], vy[pi], px[pi] - px[ai], py[pi] - py[ai], dx, dy]
        rows += [rew, on_goal.to(torch.float32), shaping]
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through."""
        A, w, base = self.n_agents, self.obs_w, self.base
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        rew = extra[..., base, :]
        on_goal = extra[..., base + 1, :] > 0.5
        shaping = extra[..., base + 2, :]
        rews = tuple(rew for _ in range(A))
        return obs, rews, on_goal, {"on_goal": on_goal, "global_shaping": shaping, "rew": rew}

    def kernel_emit(self):
        if self._kernel_emit is None:
            ep = K.EmitParams()
            ep.carry_idx[0] = self.carry_extra_idx[0]
            p = ep.reverse_transport
            p.n_agents, p.goal, p.pkg = self.n_agents, self.goal_i, self.pkg_i
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            p.hw, p.hl, p.og_dmin, p.factor = self.pkg_hw, self.pkg_hl, self.og_dmin, self.factor
            self._kernel_emit = (K.EMIT_REVERSE_TRANSPORT, ep)
        return self._kernel_emit
