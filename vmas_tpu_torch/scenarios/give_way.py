"""Give way: two agents in a corridor must swap ends; one must yield into
the side passage. The agents take velocity commands, which a PID velocity
controller per agent turns into forces.

Counterpart of vmas_tpu/scenarios/give_way.py.
The ``dt_delay`` action queue is a ``[D, B, 2]`` scratch tensor per agent;
the controllers' memory lives in scratch too (``VelocityController``). Its
outputs come out of the fused step as rows (``GiveWayOutputs``), and in the
rows form the controller runs inside the kernel (``fused.PidActRows``).
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
        self.v_range = kwargs.pop("v_range", 0.5)
        self.a_range = kwargs.pop("a_range", 1)
        self.obs_noise = kwargs.pop("obs_noise", 0)
        self.box_agents = kwargs.pop("box_agents", False)
        self.linear_friction = kwargs.pop("linear_friction", 0.1)
        self.mirror_passage = kwargs.pop("mirror_passage", False)
        self.done_on_completion = kwargs.pop("done_on_completion", False)
        self.observe_rel_pos = kwargs.pop("observe_rel_pos", False)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1.0)
        self.final_reward = kwargs.pop("final_reward", 0.01)
        self.energy_reward_coeff = kwargs.pop("energy_rew_coeff", 0)
        self.agent_collision_penalty = kwargs.pop("agent_collision_penalty", 0)
        self.passage_collision_penalty = kwargs.pop("passage_collision_penalty", 0)
        self.obstacle_collision_penalty = kwargs.pop("obstacle_collision_penalty", 0)
        self.use_velocity_controller = kwargs.pop("use_velocity_controller", True)
        self.min_input_norm = kwargs.pop("min_input_norm", 0.08)
        self.dt_delay = kwargs.pop("dt_delay", 0)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        # the viewer's settings (render/viewer.py)
        self.viewer_size = (1600, 700)

        controller_params = [2, 6, 0.002]
        self.f_range = self.a_range + self.linear_friction
        self.u_range = self.v_range if self.use_velocity_controller else self.f_range

        world = World(
            batch_dim, device, drag=0, dt=0.05, linear_friction=self.linear_friction,
            substeps=16 if self.box_agents else 5,
            collision_force=10000 if self.box_agents else 500,
        )

        self.agent_radius = 0.16
        self.agent_box_length = 0.32
        self.agent_box_width = 0.24
        self.spawn_pos_noise = 0.02
        self.min_collision_distance = 0.005

        def agent_shape():
            if self.box_agents:
                return Box(length=self.agent_box_length, width=self.agent_box_width)
            return Sphere(radius=self.agent_radius)

        self.controllers = {}
        for i, color in enumerate([Color.BLUE, Color.GREEN]):
            agent = Agent(
                name=f"agent_{i}", color=color, rotatable=False, linear_friction=self.linear_friction,
                shape=agent_shape(), u_range=self.u_range, f_range=self.f_range, v_range=self.v_range,
                render_action=True,
            )
            goal = Landmark(name=f"goal_{i}", collide=False, shape=Sphere(radius=self.agent_radius / 2), color=color)
            agent.goal = goal
            world.add_agent(agent)
            world.add_landmark(goal)
            if self.use_velocity_controller:
                self.controllers[agent.name] = VelocityController(agent, world, controller_params, "standard")

        self.spawn_map(world)
        return world

    # ------------------------------------------------------------------
    def spawn_map(self, world: World):
        self.scenario_length = 5
        self.passage_length = 0.4
        self.passage_width = 0.48
        self.corridor_width = self.passage_length
        self.small_ceiling_length = (self.scenario_length / 2) - (self.passage_length / 2)
        self.goal_dist_from_wall = self.agent_radius + 0.05
        self.agent_dist_from_wall = 0.5

        def line(name, length):
            lm = Landmark(name=name, collide=True, shape=Line(length=length), color=Color.BLACK)
            world.add_landmark(lm)
            return lm

        self.walls = [line(f"wall {i}", self.corridor_width) for i in range(2)]
        self.small_ceilings_1 = [line(f"ceil 1 {i}", self.small_ceiling_length) for i in range(2)]
        self.passage_1 = [
            line(f"ceil 2 {i}", self.passage_length if i == 2 else self.passage_width) for i in range(3)
        ]
        self.passage_2 = []
        if self.mirror_passage:
            self.small_ceilings_2 = [line(f"ceil 12 {i}", self.small_ceiling_length) for i in range(2)]
            self.passage_2 = [
                line(f"ceil 22 {i}", self.passage_length if i == 2 else self.passage_width) for i in range(3)
            ]
        else:
            self.floor = line("floor", self.scenario_length)

    def reset_map(self, state):
        dev = state.device
        vec = lambda x, y: torch.tensor([x, y], dtype=torch.float32, device=dev)
        upright = torch.tensor(math.pi / 2, dtype=torch.float32, device=dev)
        half = self.scenario_length / 2
        for i, lm in enumerate(self.walls):
            state = lm.set_pos(state, vec(-half if i == 0 else half, 0.0))
            state = lm.set_rot(state, upright)
        small_ceiling_pos = self.small_ceiling_length / 2 - half
        for i, lm in enumerate(self.small_ceilings_1):
            state = lm.set_pos(state, vec(-small_ceiling_pos if i == 0 else small_ceiling_pos, self.passage_length / 2))
        for i, lm in enumerate(self.passage_1[:-1]):
            x = -self.passage_length / 2 if i == 0 else self.passage_length / 2
            state = lm.set_pos(state, vec(x, self.passage_length / 2 + self.passage_width / 2))
            state = lm.set_rot(state, upright)
        state = self.passage_1[-1].set_pos(state, vec(0, self.passage_length / 2 + self.passage_width))
        if self.mirror_passage:
            for i, lm in enumerate(self.small_ceilings_2):
                x = -small_ceiling_pos if i == 0 else small_ceiling_pos
                state = lm.set_pos(state, vec(x, -self.passage_length / 2))
            for i, lm in enumerate(self.passage_2[:-1]):
                x = -self.passage_length / 2 if i == 0 else self.passage_length / 2
                state = lm.set_pos(state, vec(x, -self.passage_length / 2 - self.passage_width / 2))
                state = lm.set_rot(state, upright)
            state = self.passage_2[-1].set_pos(state, vec(0, -self.passage_length / 2 - self.passage_width))
        else:
            state = self.floor.set_pos(state, vec(0, -self.passage_length / 2))
        return state

    # ------------------------------------------------------------------
    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        blue, green = self.world.agents[0], self.world.agents[1]
        start_x = self.scenario_length / 2 - self.agent_dist_from_wall
        goal_x = self.scenario_length / 2 - self.goal_dist_from_wall
        vec = lambda x, y: torch.tensor([x, y], dtype=torch.float32, device=dev)
        noise = lambda: torch.rand((B, 2), generator=generator, device=dev) * (2 * self.spawn_pos_noise) \
            - self.spawn_pos_noise
        state = blue.set_pos(state, vec(-start_x, 0.0) + noise())
        state = blue.goal.set_pos(state, vec(goal_x, 0.0))
        state = green.set_pos(state, vec(start_x, 0.0) + noise())
        state = green.goal.set_pos(state, vec(-goal_x, 0.0))
        for vc in self.controllers.values():
            state = vc.reset(state)
        state = self.reset_map(state)

        scratch = dict(state.scenario)
        scratch["shaping"] = torch.stack(
            [safe_norm(a.pos(state) - a.goal.pos(state)) * self.pos_shaping_factor for a in self.world.agents], dim=-1
        )
        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch["goal_reached"] = torch.zeros((B,), dtype=torch.bool, device=dev)
        scratch["pos_rew"] = zeros
        scratch["final_rew"] = zeros
        if self.dt_delay > 0:
            for a in self.world.agents:
                scratch[f"queue_{a.name}"] = torch.zeros((self.dt_delay, B, 2), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def process_action(self, agent, state):
        if not self.use_velocity_controller:
            return state
        u = agent.u(state)
        if self.dt_delay > 0:
            # the action acts dt_delay steps late: a FIFO of the last actions
            scratch = dict(state.scenario)
            q = scratch[f"queue_{agent.name}"]
            scratch[f"queue_{agent.name}"] = torch.cat([q[1:], u[None]], dim=0)
            state = state.replace(scenario=scratch)
            u = q[0]
        u = F.clamp_with_row_norm(u, self.u_range)
        u = torch.where((safe_norm(u) < self.min_input_norm)[:, None], 0.0, u)
        state = agent.set_u(state, u)
        vc = self.controllers[agent.name]
        state = vc.reset(state, env_mask=safe_norm(u) < 1e-3)
        return vc.process_force(state)

    # ------------------------------------------------------------------
    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        blue, green = self.world.agents[0], self.world.agents[-1]
        blue_d = safe_norm(blue.pos(state) - blue.goal.pos(state))
        green_d = safe_norm(green.pos(state) - green.goal.pos(state))
        goal_reached = (blue_d < blue.goal.shape.radius) & (green_d < green.goal.shape.radius)
        shaping_new = torch.stack([blue_d, green_d], dim=-1) * self.pos_shaping_factor
        scratch["pos_rew"] = (scratch["shaping"] - shaping_new).sum(-1)
        scratch["shaping"] = shaping_new
        scratch["final_rew"] = torch.where(goal_reached, self.final_reward, 0.0)
        scratch["goal_reached"] = goal_reached
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        B, dev = state.batch_dim, state.device
        zeros = lambda: torch.zeros((B,), dtype=torch.float32, device=dev)
        # a zero penalty skips its distance tests: 0 * hit is 0 exactly
        agent_coll = zeros()
        if self.agent_collision_penalty != 0:
            for a in self.world.agents:
                if a is not agent:
                    hit = self.world.get_distance(state, agent, a) <= self.min_collision_distance
                    agent_coll = agent_coll + self.agent_collision_penalty * hit.to(torch.float32)
        obstacle_coll = zeros()
        passages = self.passage_1 + self.passage_2
        for lm in self.world.landmarks:
            if self.world.collides(agent, lm):
                penalty = (
                    self.passage_collision_penalty if lm in passages else self.obstacle_collision_penalty
                )
                if penalty == 0:
                    continue
                hit = self.world.get_distance(state, agent, lm) <= self.min_collision_distance
                obstacle_coll = obstacle_coll + penalty * hit.to(torch.float32)
        energy_rew = zeros()
        if self.energy_reward_coeff != 0:
            energy = safe_norm(agent.u(state)) / math.sqrt(self.world.dim_p * (self.f_range ** 2))
            energy_rew = -energy * self.energy_reward_coeff
        return s["pos_rew"] + obstacle_coll + agent_coll + energy_rew + s["final_rew"]

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

    def _obs_parts(self, agent, state):
        parts = [agent.pos(state), agent.vel(state)]
        if self.observe_rel_pos:
            parts += [agent.pos(state) - a.pos(state) for a in self.world.agents if a is not agent]
        return parts

    def observation(self, agent, state):
        return self._noisy(agent, self._obs_parts(agent, state))

    def done(self, state):
        if self.done_on_completion:
            return state.scenario["goal_reached"]
        return torch.zeros((state.batch_dim,), dtype=torch.bool, device=state.device)

    def info(self, agent, state):
        s = state.scenario
        return {"pos_rew": s["pos_rew"], "final_rew": s["final_rew"]}

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        """The fused step's outputs for the default reward config (every
        collision and energy coefficient zero); None otherwise."""
        if (
            self.agent_collision_penalty != 0
            or self.passage_collision_penalty != 0
            or self.obstacle_collision_penalty != 0
            or self.energy_reward_coeff != 0
        ):
            return None
        return GiveWayOutputs(self, world)


class GiveWayOutputs(F.FusedOutputs):
    """give_way's observations, reward and done as extra rows of the fused
    step. ``emit`` mirrors pre_rewards/observation line for line (the plain
    version); the kernel's GiveWayEmit computes the same rows on the device
    from the constants of ``kernel_emit``.

    Rows: per agent pos, vel and, with ``observe_rel_pos``, its position
    relative to each other agent (``obs_w``); then the new shapings (A),
    pos_rew, final_rew and goal_reached (3). Scratch in: the previous
    shapings, each carried from its emit row. With the velocity controller
    on and no action delay, the rows step runs it in the kernel
    (``fused.PidActRows``: 4 controller rows per agent in the carry, the
    controller's output in 2 rows per agent after each step's emit rows).
    The observation noise is drawn in ``unpack`` from the same streams as
    ``observation``'s."""

    def __init__(self, scenario, world):
        agents = world.policy_agents
        self.scenario = scenario
        self.agent_i = [a.index for a in agents]
        self.goal_i = [a.goal.index for a in agents]
        self.goal_r = [float(a.goal.shape.radius) for a in agents]
        self.n_agents = A = len(agents)
        self.factor = float(scenario.pos_shaping_factor)
        self.final = float(scenario.final_reward)
        self.rel_obs = bool(scenario.observe_rel_pos)
        self.obs_w = 4 + (2 * (A - 1) if self.rel_obs else 0)
        self.base = A * self.obs_w
        self.n_scratch_in = A
        self.n_out = self.base + A + 3
        self.carry_extra_idx = tuple(range(self.base, self.base + A))
        # with the controller off, process_action does nothing; the noisy
        # configs read per-step noise in unpack
        self.process_action_noop = not scenario.use_velocity_controller
        self.unpack_reads = ("obs_key",) if scenario.obs_noise > 0 else ()
        if scenario.use_velocity_controller and scenario.dt_delay == 0:
            self.attach_pid(F.PidActRows(agents, scenario.controllers, u_range=scenario.u_range,
                                         min_input_norm=scenario.min_input_norm))
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["shaping"].T  # [A, B]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        prev = ctx["scratch"]
        A = self.n_agents
        dist = [F._norm(px[a] - px[g], py[a] - py[g]) for a, g in zip(self.agent_i, self.goal_i)]
        goal_reached = None
        for i in range(A):
            r = dist[i] < self.goal_r[i]
            goal_reached = r if goal_reached is None else (goal_reached & r)
        shaping = [d * self.factor for d in dist]
        pos_rew = sum(prev[i] - shaping[i] for i in range(A))
        final_rew = torch.where(goal_reached, self.final, 0.0)

        rows = []
        for a in self.agent_i:
            rows += [px[a], py[a], vx[a], vy[a]]
            if self.rel_obs:
                for b in self.agent_i:
                    if b != a:
                        rows += [px[a] - px[b], py[a] - py[b]]
        return rows + shaping + [pos_rew, final_rew, goal_reached.to(torch.float32)]

    def unpack(self, extra, state):
        """Output rows [..., n_out (+ n_ctrl_out), B] -> (obs, rews,
        terminated, scratch updates); a leading rollout axis passes through
        (noise-free configs only: the noise streams are per step)."""
        A, w, base = self.n_agents, self.obs_w, self.base
        row = lambda r: extra[..., r, :]
        sc = self.scenario
        obs = []
        for i, agent in enumerate(sc.world.policy_agents):
            o = extra[..., i * w:(i + 1) * w, :].transpose(-1, -2)  # [..., B, obs_w]
            if self.unpack_reads:
                o = sc._noisy(agent, [o[..., 2 * k:2 * k + 2] for k in range(w // 2)])
            obs.append(o)
        shaping = extra[..., base:base + A, :].transpose(-1, -2)
        pos_rew, final_rew = row(base + A), row(base + A + 1)
        goal_reached = row(base + A + 2) > 0.5
        rew = pos_rew + final_rew
        done = goal_reached if sc.done_on_completion else torch.zeros_like(goal_reached)
        updates = {"shaping": shaping, "goal_reached": goal_reached, "pos_rew": pos_rew, "final_rew": final_rew}
        return tuple(obs), tuple(rew for _ in range(A)), done, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A:
                raise NotImplementedError(f"the fused kernel's give_way emit takes at most {K.MAX_A} agents")
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = ei
            p = ep.give_way
            p.n_agents = self.n_agents
            for i, (a, g, r) in enumerate(zip(self.agent_i, self.goal_i, self.goal_r)):
                p.agent[i], p.goal[i], p.goal_r[i] = a, g, r
            p.factor, p.final, p.rel_obs = self.factor, self.final, self.rel_obs
            self._kernel_emit = (K.EMIT_GIVE_WAY, ep)
        return self._kernel_emit
