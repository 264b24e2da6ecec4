"""Sampling: agents cover a field that is a mixture of Gaussians, scoring
the density of each grid cell they reach first.

Counterpart of vmas_tpu/scenarios/sampling.py. The Gaussians' centres
``locs`` [B, G, 2], the visited-cell grid ``sampled`` [B, 2 xdim /
grid_spacing, 2 ydim / grid_spacing] and the density's maximum over the grid
``max_pdf`` [B] live in scratch. Each agent sees the other agents with a
Lidar (sensors.py). No fused outputs: with ``fused_physics=True`` the fused
step runs with no emit and the hooks run around it.

Two choices keep the CPU and the GPU in step: the grid of ``_max_pdf`` is
built with numpy (``torch.arange`` rounds its float32 steps otherwise), and
a position's cell index divides by the grid spacing as a tensor (PyTorch
turns a CUDA tensor's division by a Python float into a multiplication by
its reciprocal, which can move a position on a cell edge into the next
cell).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vmas_tpu_torch.core import Agent, Sphere, World
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.sensors import Lidar
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 3)
        self.shared_rew = kwargs.pop("shared_rew", True)
        self.comms_range = kwargs.pop("comms_range", 0.0)
        self.lidar_range = kwargs.pop("lidar_range", 0.2)
        self.agent_radius = kwargs.pop("agent_radius", 0.025)
        self.xdim = kwargs.pop("xdim", 1)
        self.ydim = kwargs.pop("ydim", 1)
        self.grid_spacing = kwargs.pop("grid_spacing", 0.05)
        self.n_gaussians = kwargs.pop("n_gaussians", 3)
        self.cov = kwargs.pop("cov", 0.05)
        self.collisions = kwargs.pop("collisions", True)
        self.spawn_same_pos = kwargs.pop("spawn_same_pos", False)
        self.norm = kwargs.pop("norm", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        assert not (self.spawn_same_pos and self.collisions)
        assert (self.xdim / self.grid_spacing) % 1 == 0 and (self.ydim / self.grid_spacing) % 1 == 0
        self.covs = [self.cov] * self.n_gaussians if isinstance(self.cov, float) else self.cov
        assert len(self.covs) == self.n_gaussians

        self.plot_grid = False
        self.visualize_semidims = False
        self.n_x_cells = int((2 * self.xdim) / self.grid_spacing)
        self.n_y_cells = int((2 * self.ydim) / self.grid_spacing)
        self.agent_xspawn_range = 0 if self.spawn_same_pos else self.xdim
        self.agent_yspawn_range = 0 if self.spawn_same_pos else self.ydim
        self.x_semidim = self.xdim - self.agent_radius
        self.y_semidim = self.ydim - self.agent_radius

        world = World(batch_dim, device, x_semidim=self.x_semidim, y_semidim=self.y_semidim)
        dev = world.device
        entity_filter_agents = lambda e: isinstance(e, Agent)
        for i in range(self.n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}", render_action=True, collide=self.collisions,
                    shape=Sphere(radius=self.agent_radius),
                    sensors=(
                        [Lidar(world, angle_start=0.05, angle_end=2 * math.pi + 0.05, n_rays=12,
                               max_range=self.lidar_range, entity_filter=entity_filter_agents)]
                        if self.collisions
                        else None
                    ),
                )
            )

        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
        self._covs = f32(self.covs)
        self._spacing = f32(self.grid_spacing)
        self._half_cells = f32([self.n_x_cells / 2, self.n_y_cells / 2])
        # the sampling grid's cells, clamped to the semidims: [C, 2]
        xs = np.arange(-self.xdim, self.xdim, self.grid_spacing, dtype=np.float32)
        ys = np.arange(-self.ydim, self.ydim, self.grid_spacing, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        grid = torch.stack([f32(gx.ravel()), f32(gy.ravel())], dim=-1)
        self._grid = torch.stack([torch.clamp(grid[:, 0], -self.x_semidim, self.x_semidim),
                                  torch.clamp(grid[:, 1], -self.y_semidim, self.y_semidim)], dim=-1)
        self._deltas = f32([
            [self.grid_spacing, 0], [-self.grid_spacing, 0],
            [0, self.grid_spacing], [0, -self.grid_spacing],
            [-self.grid_spacing, -self.grid_spacing], [self.grid_spacing, -self.grid_spacing],
            [-self.grid_spacing, self.grid_spacing], [self.grid_spacing, self.grid_spacing],
        ])
        return world

    # ------------------------------------------------------------------
    def _pdf(self, locs, pos, covs=None):
        """The sum of the isotropic Gaussians' densities; pos [..., 2],
        locs [B, G, 2]; ``covs`` [G] where they lie off the world's device
        (the render hook's host copy)."""
        d = pos[..., None, :] - locs  # [..., G, 2]
        covs = self._covs if covs is None else covs
        sq = torch.sum(d * d, dim=-1)  # [..., G]
        return (torch.exp(-0.5 * sq / covs) / (2 * math.pi * covs)).sum(-1)

    def _max_pdf(self, locs):
        """The density's maximum over the sampling grid's cells [B]."""
        pdf = self._pdf(locs[:, None], self._grid[None])  # [B, C]
        return pdf.max(dim=-1).values

    def _sample(self, scratch, pos, update_sampled_flag=False, norm=True):
        """The density at ``pos`` [B, 2] (over ``max_pdf`` with ``norm``),
        0 in a cell already sampled or out of bounds; with
        ``update_sampled_flag``, the scratch with the cell marked."""
        B = pos.shape[0]
        oob = (pos[:, 0] < -self.xdim) | (pos[:, 0] > self.xdim) | (pos[:, 1] < -self.ydim) | (pos[:, 1] > self.ydim)
        pos = torch.stack([torch.clamp(pos[:, 0], -self.x_semidim, self.x_semidim),
                           torch.clamp(pos[:, 1], -self.y_semidim, self.y_semidim)], dim=-1)
        index = (pos / self._spacing + self._half_cells).to(torch.int64)  # truncation, as astype(int32)
        v = self._pdf(scratch["locs"], pos)
        if norm:
            v = v / scratch["max_pdf"]
        b = torch.arange(B, device=pos.device)
        already = scratch["sampled"][b, index[:, 0], index[:, 1]]
        v = torch.where(already | oob, 0.0, v)
        if update_sampled_flag:
            scratch = dict(scratch)
            sampled = scratch["sampled"].clone()
            sampled[b, index[:, 0], index[:, 1]] = True
            scratch["sampled"] = sampled
        return v, scratch

    # ------------------------------------------------------------------
    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        lo = torch.tensor([-self.xdim, -self.ydim], dtype=torch.float32, device=dev)
        hi = torch.tensor([self.xdim, self.ydim], dtype=torch.float32, device=dev)
        locs = torch.stack(
            [torch.rand((B, 2), generator=generator, device=dev) * (hi - lo) + lo for _ in range(self.n_gaussians)],
            dim=1,
        )  # [B, G, 2]
        scratch = dict(state.scenario)
        scratch["locs"] = locs
        scratch["sampled"] = torch.zeros((B, self.n_x_cells, self.n_y_cells), dtype=torch.bool, device=dev)
        scratch["max_pdf"] = self._max_pdf(locs)

        for agent in self.world.agents:
            x = torch.rand((B,), generator=generator, device=dev) * (2 * self.agent_xspawn_range) \
                - self.agent_xspawn_range
            y = torch.rand((B,), generator=generator, device=dev) * (2 * self.agent_yspawn_range) \
                - self.agent_yspawn_range
            state = agent.set_pos(state, torch.stack([x, y], dim=-1))
        samples = [self._sample(scratch, agent.pos(state), norm=self.norm)[0] for agent in self.world.agents]
        scratch["agent_samples"] = torch.stack(samples, dim=-1)  # [B, A]
        scratch["sampling_rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        samples = []
        for a in self.world.agents:
            v, scratch = self._sample(scratch, a.pos(state), update_sampled_flag=True, norm=self.norm)
            samples.append(v)
        scratch["agent_samples"] = torch.stack(samples, dim=-1)
        scratch["sampling_rew"] = scratch["agent_samples"].sum(-1)
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        return s["sampling_rew"] if self.shared_rew else s["agent_samples"][:, agent.slot]

    def observation(self, agent, state):
        obs = [agent.pos(state), agent.vel(state)]
        if self.collisions:
            obs.append(agent.sensors[0].measure(state))
        for delta in self._deltas:
            v, _ = self._sample(state.scenario, agent.pos(state) + delta, norm=self.norm)
            obs.append(v[:, None])
        return torch.cat(obs, dim=-1)

    def info(self, agent, state):
        return {"agent_sample": state.scenario["agent_samples"][:, agent.slot]}

    def extra_render(self, env, ax, env_index: int = 0):
        """The Gaussians' density as a heat map (evaluated on the host, from the
        frame's copy of ``locs``), the communication lines and the perimeter."""
        from vmas_tpu_torch.render import draw
        from vmas_tpu_torch.render.viewer import render_function_util

        locs = env.state.scenario["locs"][env_index : env_index + 1]  # [1, G, 2]
        covs = torch.tensor(np.asarray(self.covs, np.float32))

        def density(pts):
            return self._pdf(locs, torch.as_tensor(pts)[:, None, :], covs)[:, 0]

        render_function_util(density, (self.xdim, self.ydim), ax, cmap_alpha=0.5, precision=0.05)
        draw.draw_comm_lines(ax, env, env.state, env_index, self.comms_range)
        draw.draw_perimeter(ax, self.xdim, self.ydim)
