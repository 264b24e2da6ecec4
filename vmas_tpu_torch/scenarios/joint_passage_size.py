"""Joint passage, size variant: two agents of different sizes joined by a
bar carry it through a big-and-small opening in a wall of boxes to a goal
pose.

Counterpart of vmas_tpu/scenarios/joint_passage_size.py. Its world drives
the joint between the agents (and with ``asym_package`` a mass fixed on the
bar), the sphere-sphere, line-sphere and box-sphere contacts and 5 substeps
(10 with ``asym_package``); its outputs come out of the fused step as rows
(``JointPassageSizeOutputs``). Each reset places the big opening (two slots)
and the small one (one slot, left or right of it) per env, and keeps their
positions, the pass centre and the middle angle in scratch, which the rows
carry as scratch rows.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.controllers import VelocityController
from vmas_tpu_torch.core import Agent, Box, Color, Joint, Landmark, Line, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import Y, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.joint_passage import _angle_to_vector
from vmas_tpu_torch.utils import ScenarioUtils


def _angle_dist_180(a, b):
    """|a - b| on angles mod pi, the nearer way round (the JAX package's
    get_line_angle_dist_0_180, ``jnp.mod`` as ``fused._mod_pi``)."""
    a, b = F._mod_pi(a), F._mod_pi(b)
    return torch.minimum(torch.abs(a - b), torch.minimum(torch.abs(a - (b - math.pi)), torch.abs((a - math.pi) - b)))


def _angle_dist_360(a, b):
    """Minus the dot product of the two angles' directions (the JAX
    package's get_line_angle_dist_0_360)."""
    return -(torch.cos(a) * torch.cos(b) + torch.sin(a) * torch.sin(b))


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.fixed_passage = kwargs.pop("fixed_passage", False)
        self.joint_length = kwargs.pop("joint_length", 0.52)
        self.random_start_angle = kwargs.pop("random_start_angle", False)
        self.random_goal_angle = kwargs.pop("random_goal_angle", False)
        self.observe_joint_angle = kwargs.pop("observe_joint_angle", False)
        self.joint_angle_obs_noise = kwargs.pop("joint_angle_obs_noise", 0.0)
        self.asym_package = kwargs.pop("asym_package", False)
        self.mass_ratio = kwargs.pop("mass_ratio", 1)
        self.mass_position = kwargs.pop("mass_position", 0.75)
        self.max_speed_1 = kwargs.pop("max_speed_1", None)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.rot_shaping_factor = kwargs.pop("rot_shaping_factor", 1)
        self.collision_reward = kwargs.pop("collision_reward", 0)
        self.energy_reward_coeff = kwargs.pop("energy_reward_coeff", 0)
        self.obs_noise = kwargs.pop("obs_noise", 0.0)
        self.n_passages = kwargs.pop("n_passages", 3)
        self.middle_angle_180 = kwargs.pop("middle_angle_180", False)
        self.use_vel_controller = kwargs.pop("use_vel_controller", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        # the viewer's settings (render/viewer.py)
        self.plot_grid = False
        self.visualize_semidims = False
        assert self.n_passages in (3, 4)

        world = World(
            batch_dim, device, x_semidim=1, y_semidim=1,
            substeps=5 if not self.asym_package else 10,
            joint_force=700 if self.asym_package else 400,
            collision_force=2500 if self.asym_package else 1500,
            drag=0.25 if not self.asym_package else 0.15,
        )
        if not self.observe_joint_angle:
            assert self.joint_angle_obs_noise == 0

        self.n_agents = 2
        self.agent_radius = 0.03333
        self.agent_radius_2 = 3 * self.agent_radius
        self.mass_radius = self.agent_radius * (2 / 3)
        self.passage_width = 0.2
        self.passage_length = 0.1476
        self.scenario_length = 2 + 2 * self.agent_radius
        self.n_boxes = int(self.scenario_length // self.passage_length)
        self.min_collision_distance = 0.005

        controller_params = [2.0, 10, 0.00001]
        self.controllers = {}
        agent = Agent(name="agent_0", shape=Sphere(self.agent_radius), u_range=1, obs_noise=self.obs_noise,
                      render_action=True, f_range=10)
        self.controllers[agent.name] = VelocityController(agent, world, controller_params, "standard")
        world.add_agent(agent)
        agent = Agent(
            name="agent_1", shape=Sphere(self.agent_radius_2), u_range=1,
            mass=1 if self.asym_package else self.mass_ratio, max_speed=self.max_speed_1, obs_noise=self.obs_noise,
            render_action=True, f_range=10,
        )
        self.controllers[agent.name] = VelocityController(agent, world, controller_params, "standard")
        world.add_agent(agent)

        self.joint = Joint(
            world.agents[0], world.agents[1], anchor_a=(0, 0), anchor_b=(0, 0), dist=self.joint_length,
            rotate_a=True, rotate_b=True, collidable=False, width=0, mass=1,
        )
        world.add_joint(self.joint)
        if self.asym_package:
            self.mass = Landmark(
                name="mass", shape=Sphere(radius=self.mass_radius), collide=True, movable=True, color=Color.BLACK,
                mass=self.mass_ratio, collision_filter=lambda e: not isinstance(e.shape, Sphere),
            )
            world.add_landmark(self.mass)
            world.add_joint(Joint(self.mass, self.joint.landmark, anchor_a=(0, 0), anchor_b=(self.mass_position, 0),
                                  dist=0, rotate_a=True, rotate_b=True))

        self.goal = Landmark(name="joint_goal", shape=Line(length=self.joint_length), collide=False,
                             color=Color.GREEN)
        world.add_landmark(self.goal)
        self.walls = []
        for i in range(4):
            wall = Landmark(name=f"wall {i}", collide=True, shape=Line(length=2 + self.agent_radius * 2),
                            color=Color.BLACK)
            world.add_landmark(wall)
            self.walls.append(wall)

        # the passages: the first n_passages are the open (non-colliding) ones
        self.passages = []
        self.collide_passages = []
        self.non_collide_passages = []
        for i in range(self.n_boxes):
            passage = Landmark(
                name=f"passage {i}", collide=not (i < self.n_passages), movable=False,
                shape=Box(length=self.passage_length, width=self.passage_width), color=Color.RED,
                collision_filter=lambda e: not isinstance(e.shape, Box),
            )
            (self.collide_passages if passage.collide else self.non_collide_passages).append(passage)
            self.passages.append(passage)
            world.add_landmark(passage)
        return world

    # ------------------------------------------------------------------
    def _slot_pos(self, i):
        """World position of passage slot ``i`` ([B] float)."""
        x = -1 - self.agent_radius + self.passage_length / 2 + self.passage_length * i
        return torch.stack([x, torch.zeros_like(x)], dim=-1)

    def spawn_passage_map(self, state, generator):
        B, dev = state.batch_dim, state.device
        if self.fixed_passage:
            big_start = torch.full((B,), 5, dtype=torch.int64, device=dev)
            small_lr = torch.full((B,), 1, dtype=torch.int64, device=dev)
        else:
            big_start = torch.randint(0, self.n_boxes - 1, (B,), generator=generator, device=dev)
            small_lr = torch.randint(0, 2, (B,), generator=generator, device=dev)
        small_lr = torch.where(big_start > self.n_boxes - 1 - (self.n_passages + 1), 0, small_lr)
        small_lr = torch.where(big_start < self.n_passages, 1, small_lr)
        small_lr = torch.where(small_lr == 0, -3, small_lr)
        small_lr = torch.where(small_lr == 1, 4, small_lr)  # 1 + 3

        open_list = [big_start, big_start + 1, big_start + small_lr]
        if self.n_passages == 4:
            open_list.append(big_start + small_lr + torch.sign(small_lr))
        open_idx = torch.stack(open_list, dim=-1)  # [B, n_passages]
        for k, passage in enumerate(self.non_collide_passages):
            state = passage.set_rendering(state, False)
            state = passage.set_pos(state, self._slot_pos(open_idx[:, k].to(torch.float32)))

        # the closed passages take the unblocked slots in ascending order
        n_total = self.n_boxes + self.n_passages + 2
        arr = torch.arange(n_total, device=dev)
        blocked = (arr[None, :, None] == open_idx[:, None, :]).any(-1)
        order = torch.argsort(torch.where(blocked, n_total + arr, arr), dim=-1, stable=True)
        for k, passage in enumerate(self.collide_passages):
            state = passage.set_pos(state, self._slot_pos(order[:, k].to(torch.float32)))

        big_pos = (self._slot_pos(big_start.to(torch.float32)) + self._slot_pos((big_start + 1).to(torch.float32))) / 2
        small_pos = self._slot_pos((big_start + small_lr).to(torch.float32))
        scratch = dict(state.scenario)
        scratch["big_passage_pos"] = big_pos
        scratch["small_passage_pos"] = small_pos
        scratch["pass_center"] = (big_pos + small_pos) / 2
        scratch["small_left_or_right"] = small_lr.to(torch.int32)
        scratch["middle_angle"] = torch.where(small_lr > 0, math.pi, 0.0).to(torch.float32)
        return state.replace(scenario=scratch)

    def spawn_walls(self, state):
        dev = state.device
        for i, wall in enumerate(self.walls):
            x = 0.0 if i % 2 else (1 + self.agent_radius if i == 0 else -1 - self.agent_radius)
            y = 0.0 if not i % 2 else (1 + self.agent_radius if i == 1 else -1 - self.agent_radius)
            state = wall.set_pos(state, torch.tensor([x, y], dtype=torch.float32, device=dev))
            state = wall.set_rot(state, torch.tensor(math.pi / 2 if not i % 2 else 0.0, dtype=torch.float32,
                                                     device=dev))
        return state

    def _middle_angle_dist(self, state):
        rot = self.joint.landmark.rot(state)
        mid = state.scenario["middle_angle"]
        return _angle_dist_180(rot, mid) if self.middle_angle_180 else _angle_dist_360(rot, mid)

    # ------------------------------------------------------------------
    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device

        def uniform(shape, lo, hi):
            return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

        start_angle = torch.where(uniform((B,), 0.0, 1.0) >= 0.5, math.pi / 2, -math.pi / 2)
        if self.random_goal_angle:
            goal_angle = uniform((B,), -math.pi / 2, math.pi / 2)
        else:
            goal_angle = torch.full((B,), math.pi, dtype=torch.float32, device=dev)

        bigger_radius = max(self.agent_radius, self.agent_radius_2)
        half = self.joint_length / 2
        sdx, sdy = half * torch.cos(start_angle), half * torch.sin(start_angle)
        gdx, gdy = half * torch.cos(goal_angle), half * torch.sin(goal_angle)

        min_x_s = -1 + (bigger_radius + torch.abs(sdx))
        max_x_s = 1 - (bigger_radius + torch.abs(sdx))
        min_y_s = -1 + (bigger_radius + torch.abs(sdy))
        max_y_s = -2 * bigger_radius - self.passage_width / 2 - torch.abs(sdy)
        min_x_g = -1 + (bigger_radius + torch.abs(gdx))
        max_x_g = 1 - (bigger_radius + torch.abs(gdx))
        min_y_g = 2 * bigger_radius + self.passage_width / 2 + torch.abs(gdy)
        max_y_g = 1 - (bigger_radius + torch.abs(gdy))

        r = torch.rand((B, 2), generator=generator, device=dev)
        joint_pos = torch.stack(
            [(min_x_s - max_x_s) * r[:, 0] + max_x_s, (min_y_s - max_y_s) * r[:, 1] + max_y_s], dim=-1
        )
        rg = torch.rand((B, 2), generator=generator, device=dev)
        goal_pos = torch.stack(
            [(min_x_g - max_x_g) * rg[:, 0] + max_x_g, (min_y_g - max_y_g) * rg[:, 1] + max_y_g], dim=-1
        )
        state = self.goal.set_pos(state, goal_pos)
        state = self.goal.set_rot(state, goal_angle)

        delta = torch.stack([sdx, sdy], dim=-1)
        for agent in self.world.agents:
            state = self.controllers[agent.name].reset(state)
        state = self.world.agents[0].set_pos(state, joint_pos - delta)
        state = self.world.agents[1].set_pos(state, joint_pos + delta)
        if self.asym_package:
            state = self.mass.set_pos(state, joint_pos + self.mass_position * delta)

        state = self.spawn_passage_map(state, generator)
        state = self.spawn_walls(state)
        state = self.world.sync_joints(state)

        jl = self.joint.landmark
        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch = dict(state.scenario)
        scratch["t"] = zeros
        scratch["passed"] = zeros
        scratch["pos_shaping_pre"] = safe_norm(jl.pos(state) - scratch["pass_center"]) * self.pos_shaping_factor
        scratch["pos_shaping_post"] = safe_norm(jl.pos(state) - goal_pos) * self.pos_shaping_factor
        state = state.replace(scenario=scratch)
        scratch = dict(state.scenario)
        scratch["rot_shaping_pre"] = self._middle_angle_dist(state) * self.rot_shaping_factor
        for k in ["rew", "pos_rew", "rot_rew", "collision_rew", "energy_rew"]:
            scratch[k] = zeros
        scratch["just_passed"] = torch.zeros((B,), dtype=torch.bool, device=dev)
        return state.replace(scenario=scratch)

    def process_action(self, agent, state):
        if self.use_vel_controller:
            vc = self.controllers[agent.name]
            state = vc.reset(state, env_mask=safe_norm(agent.u(state)) < 1e-3)
            return vc.process_force(state)
        return state

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        B, dev = state.batch_dim, state.device
        zero = torch.zeros((B,), dtype=torch.float32, device=dev)
        jl = self.joint.landmark
        scratch["t"] = scratch["t"] + 1
        joint_passed = jl.pos(state)[:, Y] > 0
        all_passed = (
            torch.stack([a.pos(state)[:, Y] for a in self.world.agents], dim=1) > self.passage_width / 2
        ).all(dim=1)

        dist_pass = safe_norm(jl.pos(state) - scratch["pass_center"]) * self.pos_shaping_factor
        pos_rew = torch.where(~joint_passed, scratch["pos_shaping_pre"] - dist_pass, zero)
        scratch["pos_shaping_pre"] = dist_pass

        dist_goal = safe_norm(jl.pos(state) - self.goal.pos(state)) * self.pos_shaping_factor
        pos_rew = pos_rew + torch.where(joint_passed, scratch["pos_shaping_post"] - dist_goal, zero)
        scratch["pos_shaping_post"] = dist_goal

        rot_shaping = self._middle_angle_dist(state) * self.rot_shaping_factor
        rot_rew = scratch["rot_shaping_pre"] - rot_shaping
        scratch["rot_shaping_pre"] = rot_shaping

        coll = zero
        if self.collision_reward != 0:
            bodies = self.world.agents + ([self.mass] if self.asym_package else [])
            for a in bodies:
                for p in self.collide_passages + self.walls:
                    hit = self.world.get_distance(state, a, p) <= self.min_collision_distance
                    coll = coll + self.collision_reward * hit.to(torch.float32)

        energy_rew = zero
        if self.energy_reward_coeff != 0:
            energy = torch.stack(
                [
                    safe_norm(a.u(state))
                    / math.sqrt(self.world.dim_p * float((a.u_range_array[0] * a.u_multiplier_array[0]) ** 2))
                    for a in self.world.agents
                ],
                dim=1,
            ).sum(-1)
            energy_rew = -energy * self.energy_reward_coeff

        scratch["pos_rew"] = pos_rew
        scratch["rot_rew"] = rot_rew
        scratch["collision_rew"] = coll
        scratch["energy_rew"] = energy_rew
        scratch["rew"] = pos_rew + rot_rew + coll + energy_rew
        scratch["just_passed"] = all_passed & (scratch["passed"] == 0)
        scratch["passed"] = torch.where(scratch["just_passed"], 100.0, scratch["passed"])
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["rew"]

    def _noisy(self, agent, parts, joint_angle=None):
        """Observation parts with this step's noise: the joint angle's
        gaussian (then its direction vector appended), and each part's
        uniform noise, from the agent's noise streams."""
        if joint_angle is not None:
            if self.joint_angle_obs_noise:
                gen = self.obs_generator(100 + agent.slot)
                joint_angle = joint_angle + (
                    torch.randn(joint_angle.shape, generator=gen, device=joint_angle.device)
                    * self.joint_angle_obs_noise
                )
            parts = parts + [_angle_to_vector(joint_angle)]
        if self.obs_noise > 0:
            parts = [
                p + (torch.rand(p.shape, generator=self.obs_generator(agent.slot * 20 + i), device=p.device) * 2 - 1)
                * self.obs_noise
                for i, p in enumerate(parts)
            ]
        return torch.cat(parts, dim=-1)

    def observation(self, agent, state):
        s = state.scenario
        parts = [
            agent.pos(state),
            agent.vel(state),
            agent.pos(state) - self.goal.pos(state),
            agent.pos(state) - s["big_passage_pos"],
            agent.pos(state) - s["small_passage_pos"],
            _angle_to_vector(self.goal.rot(state)),
        ]
        joint_angle = self.joint.landmark.rot(state) if self.observe_joint_angle else None
        return self._noisy(agent, parts, joint_angle)

    def done(self, state):
        jl = self.joint.landmark
        return (safe_norm(jl.pos(state) - self.goal.pos(state)) <= 0.01) & (
            _angle_dist_180(jl.rot(state), self.goal.rot(state)) <= 0.01
        )

    def info(self, agent, state):
        s = state.scenario
        return {
            "pos_rew": s["pos_rew"],
            "rot_rew": s["rot_rew"],
            "collision_rew": s["collision_rew"],
            "energy_rew": s["energy_rew"],
            "passed": s["just_passed"].to(torch.int32),
        }

    def make_fused_outputs(self, world):
        """The fused step's outputs for the default reward config (no
        collision or energy reward); None otherwise."""
        if self.collision_reward != 0 or self.energy_reward_coeff != 0:
            return None
        return JointPassageSizeOutputs(self, world)

    def extra_render(self, env, ax, env_index: int = 0):
        """Goal discs at the two ends of the goal bar."""
        import numpy as np

        from vmas_tpu_torch.render import draw

        p = self.goal.pos(env.state)[env_index].numpy()
        r = float(self.goal.rot(env.state)[env_index].reshape(-1)[0])
        d = self.joint_length / 2 * np.array([np.cos(r), np.sin(r)])
        for end in (p - d, p + d):
            draw.draw_circle(ax, end, self.agent_radius, self.goal.color, filled=True)


class JointPassageSizeOutputs(F.FusedOutputs):
    """joint_passage_size's observations, reward and done as extra rows of
    the fused step. ``emit`` mirrors the JAX package's emit row for row (the
    plain version); the kernel's JointPassageSizeEmit computes the same
    rows from the constants of ``kernel_emit``.

    Rows: per agent pos, vel, pos - goal, pos - the big passage, pos - the
    small passage, the goal's direction (cos, sin) and, if observed, the
    bar's raw rotation (``obs_w``); then rew, pos_rew, rot_rew, the three
    new shapings, passed, just_passed and done (9). Scratch in (11):
    pos_shaping_pre, pos_shaping_post, rot_shaping_pre and passed, each
    carried from its emit row, then the per-env map the reset chose and the
    rows carry unchanged: the pass centre (x, y), the middle angle and the
    big and small passages' positions. The ``t`` clock is a step counter
    the rows rollouts set to ``t0 + horizon`` at their end
    (``step_count_keys``). With ``use_vel_controller=True`` the rows step
    runs the velocity controller in the kernel (``fused.PidActRows``). The
    observation noise is drawn in ``unpack`` from the same streams as
    ``observation``'s."""

    n_scratch_in = 11
    step_count_keys = ("t",)

    def __init__(self, scenario, world):
        self.scenario = scenario
        self.agent_i = [a.index for a in world.policy_agents]
        self.n_agents = A = len(self.agent_i)
        self.jl_i = scenario.joint.landmark.index
        self.goal_i = scenario.goal.index
        self.pw_half = scenario.passage_width / 2
        self.pos_f = float(scenario.pos_shaping_factor)
        self.rot_f = float(scenario.rot_shaping_factor)
        self.mid_180 = bool(scenario.middle_angle_180)
        self.obs_joint = bool(scenario.observe_joint_angle)
        self.obs_w = 12 + (1 if self.obs_joint else 0)
        self.base = A * self.obs_w
        self.n_out = self.base + 9
        # with the controller off, process_action does nothing; the noisy
        # configs read per-step noise in unpack
        self.process_action_noop = not scenario.use_vel_controller
        noisy = scenario.obs_noise > 0 or scenario.joint_angle_obs_noise > 0
        self.unpack_reads = ("obs_key",) if noisy else ()
        self.carry_extra_idx = tuple(self.base + 3 + k for k in range(4)) + (None,) * 7
        if scenario.use_vel_controller:
            self.attach_pid(F.PidActRows(world.policy_agents, scenario.controllers))
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        s = state.scenario
        return torch.stack([
            s["pos_shaping_pre"], s["pos_shaping_post"], s["rot_shaping_pre"], s["passed"],
            s["pass_center"][:, 0], s["pass_center"][:, 1], s["middle_angle"],
            s["big_passage_pos"][:, 0], s["big_passage_pos"][:, 1],
            s["small_passage_pos"][:, 0], s["small_passage_pos"][:, 1],
        ])

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rot = ctx["rot"]
        pp_pre, pp_post, rp_pre, passed, pc_x, pc_y, mid, big_x, big_y, small_x, small_y = ctx["scratch"]
        jl, gi = self.jl_i, self.goal_i

        joint_passed = py[jl] > 0
        all_passed = None
        for ai in self.agent_i:
            ok = py[ai] > self.pw_half
            all_passed = ok if all_passed is None else (all_passed & ok)

        dist_pass = F._norm(px[jl] - pc_x, py[jl] - pc_y) * self.pos_f
        pos_rew = torch.where(~joint_passed, pp_pre - dist_pass, 0.0)
        dist_goal_raw = F._norm(px[jl] - px[gi], py[jl] - py[gi])
        dist_goal = dist_goal_raw * self.pos_f
        pos_rew = pos_rew + torch.where(joint_passed, pp_post - dist_goal, 0.0)
        if self.mid_180:
            rot_shaping = _angle_dist_180(rot[jl], mid) * self.rot_f
        else:
            rot_shaping = _angle_dist_360(rot[jl], mid) * self.rot_f
        rot_rew = rp_pre - rot_shaping

        rew = pos_rew + rot_rew
        just_passed = all_passed & (passed == 0)
        passed_new = torch.where(just_passed, 100.0, passed)
        done = (dist_goal_raw <= 0.01) & (_angle_dist_180(rot[jl], rot[gi]) <= 0.01)
        gc, gs = torch.cos(rot[gi]), torch.sin(rot[gi])

        rows = []
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai], px[ai] - px[gi], py[ai] - py[gi], px[ai] - big_x,
                     py[ai] - big_y, px[ai] - small_x, py[ai] - small_y, gc, gs]
            if self.obs_joint:
                rows.append(rot[jl])  # raw; unpack adds the noise
        rows += [rew, pos_rew, rot_rew, dist_pass, dist_goal, rot_shaping, passed_new,
                 just_passed.to(torch.float32), done.to(torch.float32)]
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through (with observation
        noise, one step's rows: the noise streams are per step)."""
        A, w, base = self.n_agents, self.obs_w, self.base
        row = lambda r: extra[..., r, :]
        obs = []
        for i in range(A):
            o = extra[..., i * w:(i + 1) * w, :].transpose(-1, -2)  # [..., B, obs_w]
            parts = [o[..., 2 * k:2 * k + 2] for k in range(6)]
            angle = o[..., 12] if self.obs_joint else None
            if self.unpack_reads:
                obs.append(self.scenario._noisy(self.scenario.world.policy_agents[i], parts, angle))
            else:
                if angle is not None:
                    parts.append(_angle_to_vector(angle))
                obs.append(torch.cat(parts, dim=-1))
        rew = row(base)
        zeros = torch.zeros_like(rew)
        updates = {
            "t": state.scenario["t"] + 1,
            "rew": rew, "pos_rew": row(base + 1), "rot_rew": row(base + 2),
            "collision_rew": zeros, "energy_rew": zeros,
            "pos_shaping_pre": row(base + 3), "pos_shaping_post": row(base + 4), "rot_shaping_pre": row(base + 5),
            "passed": row(base + 6), "just_passed": row(base + 7) > 0.5,
        }
        return tuple(obs), tuple(rew for _ in range(A)), row(base + 8) > 0.5, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A:
                raise NotImplementedError(f"the fused kernel's joint_passage_size emit takes at most {K.MAX_A} agents")
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = -1 if ei is None else ei
            p = ep.joint_passage_size
            p.n_agents = self.n_agents
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            p.jl, p.goal = self.jl_i, self.goal_i
            p.pw_half, p.pos_f, p.rot_f = self.pw_half, self.pos_f, self.rot_f
            p.mid_180, p.obs_joint = self.mid_180, self.obs_joint
            self._kernel_emit = (K.EMIT_JOINT_PASSAGE_SIZE, ep)
        return self._kernel_emit
