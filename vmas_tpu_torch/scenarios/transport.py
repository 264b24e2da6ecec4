"""Transport: N agents push heavy box packages onto a goal; dense shaping
reward.

Counterpart of vmas_tpu/scenarios/transport.py (the heuristic policy is
not ported yet). The per-package attributes (on_goal, global_shaping) are
``[B, P]`` scratch tensors and the reward bookkeeping is the pre_rewards
hook.
"""

from __future__ import annotations

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
        self.n_packages = kwargs.pop("n_packages", 1)
        self.package_width = kwargs.pop("package_width", 0.15)
        self.package_length = kwargs.pop("package_length", 0.15)
        self.package_mass = kwargs.pop("package_mass", 50)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.shaping_factor = 100
        self.world_semidim = 1
        self.agent_radius = 0.03

        world = World(
            batch_dim,
            device,
            x_semidim=self.world_semidim + 2 * self.agent_radius + max(self.package_length, self.package_width),
            y_semidim=self.world_semidim + 2 * self.agent_radius + max(self.package_length, self.package_width),
        )
        for i in range(n_agents):
            world.add_agent(Agent(name=f"agent_{i}", shape=Sphere(self.agent_radius), u_multiplier=0.6))
        self.goal = Landmark(name="goal", collide=False, shape=Sphere(radius=0.15), color=Color.LIGHT_GREEN)
        world.add_landmark(self.goal)
        self.packages = []
        for i in range(self.n_packages):
            package = Landmark(
                name=f"package {i}",
                collide=True,
                movable=True,
                mass=self.package_mass,
                shape=Box(length=self.package_length, width=self.package_width),
                color=Color.RED,
            )
            package.goal = self.goal
            self.packages.append(package)
            world.add_landmark(package)
        return world

    # ------------------------------------------------------------------
    def reset_world_at(self, state, generator):
        state = ScenarioUtils.spawn_entities_randomly(
            self.world.agents, self.world, state, generator,
            min_dist_between_entities=self.agent_radius * 2,
            x_bounds=(-self.world_semidim, self.world_semidim),
            y_bounds=(-self.world_semidim, self.world_semidim),
        )
        agent_idx = [a.index for a in self.world.agents]
        agent_occupied = state.pos[:, agent_idx]
        state = ScenarioUtils.spawn_entities_randomly(
            [self.goal] + self.packages, self.world, state, generator,
            min_dist_between_entities=max(
                p.shape.circumscribed_radius() + self.goal.shape.radius + 0.01 for p in self.packages
            ),
            x_bounds=(-self.world_semidim, self.world_semidim),
            y_bounds=(-self.world_semidim, self.world_semidim),
            occupied_positions=agent_occupied,
        )

        on_goal = torch.stack([self.world.is_overlapping(state, p, self.goal) for p in self.packages], dim=-1)
        global_shaping = (
            torch.stack([safe_norm(p.pos(state) - self.goal.pos(state)) for p in self.packages], dim=-1)
            * self.shaping_factor
        )
        scratch = dict(state.scenario)
        scratch["on_goal"] = on_goal  # [B, P]
        scratch["global_shaping"] = global_shaping  # [B, P]
        scratch["rew"] = torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)
        return state.replace(scenario=scratch)

    # ------------------------------------------------------------------
    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        dist_to_goal = torch.stack(
            [safe_norm(p.pos(state) - self.goal.pos(state)) for p in self.packages], dim=-1
        )
        on_goal = torch.stack([self.world.is_overlapping(state, p, self.goal) for p in self.packages], dim=-1)
        package_shaping = dist_to_goal * self.shaping_factor
        contrib = torch.where(~on_goal, scratch["global_shaping"] - package_shaping, torch.zeros_like(package_shaping))
        scratch["global_shaping"] = package_shaping
        scratch["on_goal"] = on_goal
        scratch["rew"] = contrib.sum(dim=-1)
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["rew"]

    def observation(self, agent, state):
        obs = [agent.pos(state), agent.vel(state)]
        for i, package in enumerate(self.packages):
            obs.append(package.pos(state) - self.goal.pos(state))
            obs.append(package.pos(state) - agent.pos(state))
            obs.append(package.vel(state))
            obs.append(state.scenario["on_goal"][:, i : i + 1].to(torch.float32))
        return torch.cat(obs, dim=-1)

    def done(self, state):
        return torch.all(state.scenario["on_goal"], dim=-1)

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return TransportOutputs(self, world)


class TransportOutputs(F.FusedOutputs):
    """Transport's observations, reward and done as extra rows of the fused
    step. ``emit`` mirrors pre_rewards/observation/done line for line (the
    plain version); the kernel's TransportEmit computes the same rows on the
    device from the constants of ``kernel_emit``."""

    def __init__(self, scenario, world):
        agents = world.policy_agents
        A, P = len(agents), len(scenario.packages)
        self.agent_i = [a.index for a in agents]
        self.goal_i = scenario.goal.index
        self.pkg_i = [p.index for p in scenario.packages]
        self.pkg_hw = [p.shape.width / 2 for p in scenario.packages]
        self.pkg_hl = [p.shape.length / 2 for p in scenario.packages]
        self.radius = float(scenario.goal.shape.radius)
        self.factor = float(scenario.shaping_factor)
        self.obs_w = 4 + 7 * P
        self.n_agents, self.n_pkgs = A, P
        self.n_scratch_in = P  # previous global_shaping per package
        self.n_out = A * self.obs_w + 1 + 2 * P
        # rows-carried rollout: the next step's scratch inputs are this
        # step's emitted shaping rows
        self.carry_extra_idx = tuple(range(A * self.obs_w + 1 + P, A * self.obs_w + 1 + 2 * P))
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["global_shaping"].T  # [P, B]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rot = ctx["rot"]
        prev = ctx["scratch"]
        gx, gy = px[self.goal_i], py[self.goal_i]

        og, shaping, rew = [], [], None
        for k, pi in enumerate(self.pkg_i):
            dx, dy = px[pi] - gx, py[pi] - gy
            dist = F._norm(dx, dy)
            # is_overlapping box-sphere (queries.is_overlapping)
            cos, sin = torch.cos(rot[pi]), torch.sin(rot[pi])
            cx, cy = F._closest_point_box(px[pi], py[pi], cos, sin, self.pkg_hw[k], self.pkg_hl[k], gx, gy)
            d_sphere_closest = F._norm(gx - cx, gy - cy)
            d_closest_box = F._norm(px[pi] - cx, py[pi] - cy)
            og_k = (dist < d_closest_box) | (d_sphere_closest < self.radius + LINE_MIN_DIST)
            shaping_k = dist * self.factor
            contrib = torch.where(og_k, 0.0, prev[k] - shaping_k)
            rew = contrib if rew is None else rew + contrib
            og.append(og_k)
            shaping.append(shaping_k)

        rows = []
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai]]
            for k, pi in enumerate(self.pkg_i):
                rows += [
                    px[pi] - gx, py[pi] - gy,
                    px[pi] - px[ai], py[pi] - py[ai],
                    vx[pi], vy[pi],
                    og[k].to(torch.float32),
                ]
        rows.append(rew)
        rows += [o.to(torch.float32) for o in og]
        rows += shaping
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through."""
        A, P, w = self.n_agents, self.n_pkgs, self.obs_w
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        base = A * w
        rew = extra[..., base, :]
        og = extra[..., base + 1:base + 1 + P, :].transpose(-1, -2) > 0.5  # [..., B, P]
        shaping = extra[..., base + 1 + P:base + 1 + 2 * P, :].transpose(-1, -2)
        rews = tuple(rew for _ in range(A))
        terminated = torch.all(og, dim=-1)
        updates = {"on_goal": og, "global_shaping": shaping, "rew": rew}
        return obs, rews, terminated, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A or self.n_pkgs > K.MAX_P or self.n_scratch_in > K.MAX_K:
                raise NotImplementedError(
                    f"the fused kernel's transport emit takes at most {K.MAX_A} agents and "
                    f"{K.MAX_P} packages"
                )
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = -1 if ei is None else int(ei)
            ep.n_agents, ep.n_pkgs, ep.goal = self.n_agents, self.n_pkgs, self.goal_i
            for i, ai in enumerate(self.agent_i):
                ep.agent[i] = ai
            for k, pi in enumerate(self.pkg_i):
                ep.pkg[k], ep.hw[k], ep.hl[k] = pi, self.pkg_hw[k], self.pkg_hl[k]
            ep.og_dmin = self.radius + LINE_MIN_DIST
            ep.factor = self.factor
            self._kernel_emit = (K.EMIT_TRANSPORT, ep)
        return self._kernel_emit
