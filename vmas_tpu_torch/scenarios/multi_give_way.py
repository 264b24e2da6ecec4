"""Multi give way: four agents cross a four-way intersection of corridors,
each to the start of the next; they take velocity commands, which a PID
velocity controller per agent turns into forces.

Counterpart of vmas_tpu/scenarios/multi_give_way.py. Its outputs come out of
the fused step as rows (``MultiGiveWayOutputs``, sphere agents only), with
the pairwise collision penalties in the kernel; in the rows form the
controller runs inside the kernel too (``fused.PidActRows``).
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.controllers import VelocityController
from vmas_tpu_torch.core import Agent, Box, Color, Landmark, Line, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.u_range = kwargs.pop("u_range", 0.5)
        self.a_range = kwargs.pop("a_range", 1)
        self.obs_noise = kwargs.pop("obs_noise", 0)
        self.box_agents = kwargs.pop("box_agents", False)
        self.linear_friction = kwargs.pop("linear_friction", 0.1)
        self.min_input_norm = kwargs.pop("min_input_norm", 0.08)
        self.comms_range = kwargs.pop("comms_range", 5)
        self.shared_rew = kwargs.pop("shared_rew", True)
        kwargs.pop("n_agents", 4)  # always 4
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.final_reward = kwargs.pop("final_reward", 0.01)
        self.agent_collision_penalty = kwargs.pop("agent_collision_penalty", -0.1)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        # the viewer's settings (render/viewer.py)
        self.viewer_zoom = 1.7

        controller_params = [2, 6, 0.002]
        self.n_agents = 4
        self.f_range = self.a_range + self.linear_friction

        world = World(
            batch_dim, device, drag=0, dt=0.1, linear_friction=self.linear_friction,
            substeps=16 if self.box_agents else 5,
            collision_force=10000 if self.box_agents else 500,
        )

        self.agent_radius = 0.16
        self.agent_box_length = 0.32
        self.agent_box_width = 0.24
        self.min_collision_distance = 0.005
        colors = [Color.GREEN, Color.BLUE, Color.RED, Color.GRAY]

        self.controllers = {}
        for i in range(self.n_agents):
            shape = (
                Box(length=self.agent_box_length, width=self.agent_box_width)
                if self.box_agents else Sphere(radius=self.agent_radius)
            )
            agent = Agent(
                name=f"agent_{i}", rotatable=False, linear_friction=self.linear_friction, shape=shape,
                u_range=self.u_range, f_range=self.f_range, render_action=True, color=colors[i],
            )
            self.controllers[agent.name] = VelocityController(agent, world, controller_params, "standard")
            goal = Landmark(name=f"goal {i}", collide=False, shape=Sphere(radius=self.agent_radius / 2),
                            color=colors[i])
            agent.goal = goal
            world.add_agent(agent)
            world.add_landmark(goal)

        self.spawn_map(world)
        return world

    def spawn_map(self, world):
        self.scenario_length = 5
        self.scenario_width = 0.4
        self.long_wall_length = (self.scenario_length / 2) - (self.scenario_width / 2)
        self.short_wall_length = self.scenario_width
        self.goal_dist_from_wall = self.agent_radius + 0.05
        self.agent_dist_from_wall = 0.5

        def line(name, length):
            lm = Landmark(name=name, collide=True, shape=Line(length=length), color=Color.BLACK)
            world.add_landmark(lm)
            return lm

        self.long_walls = [line(f"wall {i}", self.long_wall_length) for i in range(8)]
        self.short_walls = [line(f"short wall {i}", self.short_wall_length) for i in range(4)]

    def reset_map(self, state):
        dev = state.device
        vec = lambda x, y: torch.tensor([x, y], dtype=torch.float32, device=dev)
        upright = torch.tensor(math.pi / 2, dtype=torch.float32, device=dev)
        half = self.scenario_length / 2
        for i, lm in enumerate(self.short_walls):
            if i < 2:
                state = lm.set_pos(state, vec(-half if i % 2 == 0 else half, 0.0))
                state = lm.set_rot(state, upright)
            else:
                state = lm.set_pos(state, vec(0.0, -half if i % 2 == 0 else half))
        long_wall_pos = self.long_wall_length / 2 - half
        for i, lm in enumerate(self.long_walls):
            side = self.scenario_width / 2 * (-1 if i % 2 == 0 else 1)
            if i < 4:
                state = lm.set_pos(state, vec(long_wall_pos * (1 if i < 2 else -1), side))
            else:
                state = lm.set_pos(state, vec(side, long_wall_pos * (1 if i < 6 else -1)))
                state = lm.set_rot(state, upright)
        return state

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        vec = lambda x, y: torch.tensor([x, y], dtype=torch.float32, device=dev)
        start = self.scenario_length / 2 - self.agent_dist_from_wall
        goal_d = self.scenario_length / 2 - self.goal_dist_from_wall
        for i, agent in enumerate(self.world.agents):
            state = self.controllers[agent.name].reset(state)
            next_goal = self.world.agents[(i + 1) % self.n_agents].goal
            if i in (0, 2):
                state = agent.set_pos(state, vec(start * (-1 if i == 0 else 1), 0.0))
                state = next_goal.set_pos(state, vec(goal_d * (-1 if i == 0 else 1), 0.0))
            else:
                state = agent.set_pos(state, vec(0.0, start * (1 if i == 1 else -1)))
                state = next_goal.set_pos(state, vec(0.0, goal_d * (1 if i == 1 else -1)))
        state = self.reset_map(state)

        scratch = dict(state.scenario)
        scratch["shaping"] = torch.stack(
            [safe_norm(a.pos(state) - a.goal.pos(state)) * self.pos_shaping_factor for a in self.world.agents], dim=-1
        )
        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch["reached_goal"] = torch.zeros((B,), dtype=torch.bool, device=dev)
        scratch["pos_rew"] = zeros
        scratch["pos_rew_per_agent"] = torch.zeros((B, self.n_agents), dtype=torch.float32, device=dev)
        scratch["final_rew"] = zeros
        return state.replace(scenario=scratch)

    def process_action(self, agent, state):
        u = F.clamp_with_row_norm(agent.u(state), self.u_range)
        u = torch.where((safe_norm(u) < self.min_input_norm)[:, None], 0.0, u)
        state = agent.set_u(state, u)
        vc = self.controllers[agent.name]
        state = vc.reset(state, env_mask=safe_norm(u) < 1e-3)
        return vc.process_force(state)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        agents = self.world.agents
        dist = torch.stack([safe_norm(a.pos(state) - a.goal.pos(state)) for a in agents], dim=-1)
        radii = torch.tensor([a.goal.shape.radius for a in agents], dtype=torch.float32, device=state.device)
        on_goal = dist < radii[None]
        pos_shaping = dist * self.pos_shaping_factor
        if self.pos_shaping_factor != 0:
            per_agent = scratch["shaping"] - pos_shaping
        else:
            per_agent = -dist * 0.0001
        scratch["shaping"] = pos_shaping
        scratch["pos_rew_per_agent"] = per_agent
        scratch["pos_rew"] = per_agent.sum(-1)
        all_reached = on_goal.all(dim=-1)
        scratch["final_rew"] = torch.where(all_reached, self.final_reward, 0.0)
        scratch["reached_goal"] = scratch["reached_goal"] | all_reached
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        coll = torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)
        for a in self.world.agents:
            if a is not agent:
                hit = self.world.get_distance(state, agent, a) <= self.min_collision_distance
                coll = coll + self.agent_collision_penalty * hit.to(torch.float32)
        pos = s["pos_rew"] if self.shared_rew else s["pos_rew_per_agent"][:, agent.slot]
        return pos + coll + s["final_rew"]

    def _noisy(self, agent, parts):
        """Observation parts with this step's uniform noise, one stream per
        part."""
        if self.obs_noise > 0:
            parts = [
                p + (torch.rand(p.shape, generator=self.obs_generator(agent.slot * 10 + i), device=p.device) * 2 - 1)
                * self.obs_noise
                for i, p in enumerate(parts)
            ]
        return torch.cat(parts, dim=-1)

    def observation(self, agent, state):
        rel = agent.pos(state) - agent.goal.pos(state)
        return self._noisy(agent, [agent.pos(state), agent.vel(state), rel, safe_norm(rel)[:, None]])

    def info(self, agent, state):
        s = state.scenario
        return {
            "pos_rew": s["pos_rew"] if self.shared_rew else s["pos_rew_per_agent"][:, agent.slot],
            "final_rew": s["final_rew"],
        }

    def make_fused_outputs(self, world):
        """The fused step's outputs for sphere agents; None with box agents
        (their box-box distances stay on the plain path)."""
        if self.box_agents:
            return None
        return MultiGiveWayOutputs(self, world)

    def extra_render(self, env, ax, env_index: int = 0):
        """The agents' communication lines."""
        from vmas_tpu_torch.render import draw

        draw.draw_comm_lines(ax, env, env.state, env_index, self.comms_range)


class MultiGiveWayOutputs(F.FusedOutputs):
    """multi_give_way's observations, rewards and done as extra rows of the
    fused step. ``emit`` mirrors pre_rewards/reward/observation line for line
    (the plain version); the kernel's MultiGiveWayEmit computes the same
    rows on the device from the constants of ``kernel_emit``.

    Rows: per agent pos, vel, pos - goal and its norm (7); then the
    per-agent position rewards, the pairwise collision penalties and the new
    shapings (A each), final_rew and the reached_goal latch (2). Scratch in:
    the previous shapings and reached_goal, each carried from its emit row.
    The rows step runs the velocity controller in the kernel
    (``fused.PidActRows``), as give_way's does."""

    obs_w = 7

    def __init__(self, scenario, world):
        agents = world.policy_agents
        self.scenario = scenario
        self.agent_i = [a.index for a in agents]
        self.goal_i = [a.goal.index for a in agents]
        self.goal_r = [float(a.goal.shape.radius) for a in agents]
        self.n_agents = A = len(agents)
        self.factor = float(scenario.pos_shaping_factor)
        self.final = float(scenario.final_reward)
        self.coll_pen = float(scenario.agent_collision_penalty)
        self.min_coll = float(scenario.min_collision_distance)
        self.two_r = 2 * float(scenario.agent_radius)
        self.base = A * self.obs_w
        self.n_scratch_in = A + 1
        self.n_out = self.base + 3 * A + 2
        self.carry_extra_idx = tuple(range(self.base + 2 * A, self.base + 3 * A)) + (self.base + 3 * A + 1,)
        self.unpack_reads = ("obs_key",) if scenario.obs_noise > 0 else ()
        self.attach_pid(F.PidActRows(agents, scenario.controllers, u_range=scenario.u_range,
                                     min_input_norm=scenario.min_input_norm))
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        s = state.scenario
        return torch.cat([s["shaping"].T, s["reached_goal"].to(torch.float32)[None]], dim=0)

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        A = self.n_agents
        prev = ctx["scratch"][:A]
        reached_prev = ctx["scratch"][A] > 0.5
        goal_rel = [(px[a] - px[g], py[a] - py[g]) for a, g in zip(self.agent_i, self.goal_i)]
        dist = [F._norm(gx, gy) for gx, gy in goal_rel]
        shaping = [d * self.factor for d in dist]
        if self.factor != 0:
            per_agent = [prev[i] - shaping[i] for i in range(A)]
        else:
            per_agent = [-d * 0.0001 for d in dist]
        all_reached = None
        for i in range(A):
            og = dist[i] < self.goal_r[i]
            all_reached = og if all_reached is None else (all_reached & og)
        final_rew = torch.where(all_reached, self.final, 0.0)
        reached_new = reached_prev | all_reached

        coll = []
        for i, ai in enumerate(self.agent_i):
            c = None
            for j, aj in enumerate(self.agent_i):
                if j == i:
                    continue
                # the sphere-sphere distance, with 2 * radius rounded once
                d = F._norm(px[ai] - px[aj], py[ai] - py[aj]) - self.two_r
                hit = (d <= self.min_coll).to(torch.float32) * self.coll_pen
                c = hit if c is None else c + hit
            coll.append(c)

        rows = []
        for i, a in enumerate(self.agent_i):
            rows += [px[a], py[a], vx[a], vy[a], goal_rel[i][0], goal_rel[i][1], dist[i]]
        return rows + per_agent + coll + shaping + [final_rew, reached_new.to(torch.float32)]

    def unpack(self, extra, state):
        """Output rows [..., n_out (+ n_ctrl_out), B] -> (obs, rews,
        terminated, scratch updates); a leading rollout axis passes through
        (noise-free configs only: the noise streams are per step)."""
        A, w, base = self.n_agents, self.obs_w, self.base
        row = lambda r: extra[..., r, :]
        sc = self.scenario
        per_agent_rows = [row(base + i) for i in range(A)]
        # summed in agent order, as a row sum, on every path
        pos_rew = per_agent_rows[0]
        for r in per_agent_rows[1:]:
            pos_rew = pos_rew + r
        final_rew = row(base + 3 * A)
        obs = []
        for i, agent in enumerate(sc.world.policy_agents):
            o = extra[..., i * w:(i + 1) * w, :].transpose(-1, -2)  # [..., B, 7]
            if self.unpack_reads:
                o = sc._noisy(agent, [o[..., 0:2], o[..., 2:4], o[..., 4:6], o[..., 6:7]])
            obs.append(o)
        rews = tuple(
            (pos_rew if sc.shared_rew else per_agent_rows[i]) + row(base + A + i) + final_rew for i in range(A)
        )
        updates = {
            "shaping": extra[..., base + 2 * A:base + 3 * A, :].transpose(-1, -2),
            "pos_rew_per_agent": extra[..., base:base + A, :].transpose(-1, -2),
            "pos_rew": pos_rew,
            "final_rew": final_rew,
            "reached_goal": row(base + 3 * A + 1) > 0.5,
        }
        return tuple(obs), rews, torch.zeros_like(final_rew, dtype=torch.bool), updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A or len(self.carry_extra_idx) > K.MAX_K:
                raise NotImplementedError(
                    f"the fused kernel's multi_give_way emit takes at most {K.MAX_K - 1} agents"
                )
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = ei
            p = ep.multi_give_way
            p.n_agents = self.n_agents
            for i, (a, g, r) in enumerate(zip(self.agent_i, self.goal_i, self.goal_r)):
                p.agent[i], p.goal[i], p.goal_r[i] = a, g, r
            p.factor, p.factor_zero, p.final = self.factor, self.factor == 0, self.final
            p.coll_pen, p.min_coll, p.two_r = self.coll_pen, self.min_coll, self.two_r
            self._kernel_emit = (K.EMIT_MULTI_GIVE_WAY, ep)
        return self._kernel_emit
