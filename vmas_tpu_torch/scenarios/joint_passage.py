"""Joint passage: two agents joined by a rigid bar, with an asymmetric mass
on it, carry the bar through a gap in a wall of boxes to a goal pose.

Counterpart of vmas_tpu/scenarios/joint_passage.py. Its world drives the
joint constraints (three rigid constraints: the agents to the ends of the
bar, the mass to the bar), the sphere-sphere, line-sphere, box-sphere and
box-line contacts, and 10 substeps; its outputs come out of the fused step
as rows (``JointPassageOutputs``).

The bar's collision filter is static: with ``fixed_passage`` the open
slots are known when the world is built, so the bar collides only with the
passages beside an opening; otherwise with every closed passage. The
random open-slot placement is a per-env sort of the slots.
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
from vmas_tpu_torch.utils import ScenarioUtils


def _angle_dist(angle, goal):
    """|angle - goal| on angles mod pi, the nearer way round; ``goal`` a
    tensor or a float (joint_passage.py get_line_angle_dist_0_180)."""
    angle = torch.remainder(angle, math.pi)
    goal = torch.remainder(torch.as_tensor(goal, dtype=torch.float32, device=angle.device), math.pi)
    return torch.minimum(
        torch.abs(angle - goal),
        torch.minimum(torch.abs(angle - (goal - math.pi)), torch.abs((angle - math.pi) - goal)),
    )


def _angle_to_vector(angle):
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_passages = kwargs.pop("n_passages", 1)
        self.fixed_passage = kwargs.pop("fixed_passage", True)
        self.joint_length = kwargs.pop("joint_length", 0.5)
        self.random_start_angle = kwargs.pop("random_start_angle", True)
        self.random_goal_angle = kwargs.pop("random_goal_angle", True)
        self.observe_joint_angle = kwargs.pop("observe_joint_angle", False)
        self.joint_angle_obs_noise = kwargs.pop("joint_angle_obs_noise", 0.0)
        self.asym_package = kwargs.pop("asym_package", True)
        self.mass_ratio = kwargs.pop("mass_ratio", 5)
        self.mass_position = kwargs.pop("mass_position", 0.75)
        self.max_speed_1 = kwargs.pop("max_speed_1", None)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.rot_shaping_factor = kwargs.pop("rot_shaping_factor", 1)
        self.collision_reward = kwargs.pop("collision_reward", 0)
        self.energy_reward_coeff = kwargs.pop("energy_reward_coeff", 0)
        self.all_passed_rot = kwargs.pop("all_passed_rot", True)
        self.obs_noise = kwargs.pop("obs_noise", 0.0)
        self.use_controller = kwargs.pop("use_controller", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        # the viewer's settings (render/viewer.py)
        self.plot_grid = True
        self.visualize_semidims = False

        world = World(
            batch_dim, device, x_semidim=1, y_semidim=1,
            substeps=7 if not self.asym_package else 10,
            joint_force=900 if self.asym_package else 400,
            collision_force=2500 if self.asym_package else 1500,
            drag=0.25 if not self.asym_package else 0.15,
        )
        if not self.observe_joint_angle:
            assert self.joint_angle_obs_noise == 0

        self.middle_angle = math.pi / 2
        self.n_agents = 2
        self.agent_radius = 0.03333
        self.mass_radius = self.agent_radius * (2 / 3)
        self.passage_width = 0.2
        self.passage_length = 0.1476
        self.scenario_length = 2 * world.x_semidim + 2 * self.agent_radius
        self.n_boxes = int(self.scenario_length // self.passage_length)
        self.min_collision_distance = 0.005
        assert 1 <= self.n_passages <= self.n_boxes

        controller_params = [2.0, 10, 0.00001]
        self.controllers = {}
        for i in range(2):
            agent = Agent(
                name=f"agent_{i}", shape=Sphere(self.agent_radius),
                mass=(1 if self.asym_package or i == 0 else self.mass_ratio),
                color=Color.BLUE, max_speed=self.max_speed_1 if i == 1 else None,
                obs_noise=self.obs_noise, render_action=True, u_multiplier=0.8, f_range=0.8,
            )
            self.controllers[agent.name] = VelocityController(agent, world, controller_params, "standard")
            world.add_agent(agent)

        self.joint = Joint(
            world.agents[0], world.agents[1], anchor_a=(0, 0), anchor_b=(0, 0), dist=self.joint_length,
            rotate_a=True, rotate_b=True, collidable=True, width=0, mass=1,
        )
        world.add_joint(self.joint)

        if self.asym_package:
            self.mass = Landmark(
                name="mass", shape=Sphere(radius=self.mass_radius), collide=True, movable=True,
                color=Color.BLACK, mass=self.mass_ratio,
                collision_filter=lambda e: not isinstance(e.shape, Sphere),
            )
            world.add_landmark(self.mass)
            world.add_joint(
                Joint(self.mass, self.joint.landmark, anchor_a=(0, 0), anchor_b=(self.mass_position, 0),
                      dist=0, rotate_a=True, rotate_b=True)
            )

        self.goal = Landmark(name="joint_goal", shape=Line(length=self.joint_length), collide=False,
                             color=Color.GREEN)
        world.add_landmark(self.goal)

        self.walls = []
        for i in range(4):
            wall = Landmark(name=f"wall {i}", collide=True, shape=Line(length=2 + self.agent_radius * 2),
                            color=Color.BLACK)
            world.add_landmark(wall)
            self.walls.append(wall)

        self.create_passage_map(world)
        return world

    # ------------------------------------------------------------------
    def _fixed_open_slots(self):
        slots = []
        j = self.n_boxes // 2
        for i in range(self.n_passages):
            j += i * (-1 if i % 2 == 0 else 1)
            slots.append(j)
        return slots

    def create_passage_map(self, world):
        self.passages = []
        self.collide_passages = []
        self.non_collide_passages = []

        def removed(i):
            return (self.n_boxes // 2) - self.n_passages / 2 <= i < (self.n_boxes // 2) + self.n_passages / 2

        for i in range(self.n_boxes):
            passage = Landmark(
                name=f"passage {i}", collide=not removed(i), movable=False,
                shape=Box(length=self.passage_length, width=self.passage_width), color=Color.RED,
                collision_filter=lambda e: not isinstance(e.shape, Box),
            )
            (self.collide_passages if passage.collide else self.non_collide_passages).append(passage)
            self.passages.append(passage)
            world.add_landmark(passage)

        # the bar's static collision filter (see the module docstring)
        if self.fixed_passage:
            open_slots = set(self._fixed_open_slots())
            # the closed passages take the remaining slots in order
            slot_iter = (s for s in range(self.n_boxes + self.n_passages) if s not in open_slots)
            neighbour_names = set()
            for p in self.collide_passages:
                s = next(slot_iter)
                if (s - 1) in open_slots or (s + 1) in open_slots:
                    neighbour_names.add(p.name)
            names = neighbour_names
        else:
            names = {p.name for p in self.collide_passages}
        self.joint.landmark.collision_filter = lambda e: e.name in names

    def _slot_pos(self, i):
        """World position of passage slot ``i`` ([B] float)."""
        x = -1 - self.agent_radius + self.passage_length / 2 + self.passage_length * i
        return torch.stack([x, torch.zeros_like(x)], dim=-1)

    def spawn_passage_map(self, state, generator):
        B, dev = state.batch_dim, state.device
        if self.fixed_passage:
            open_idx = torch.as_tensor(self._fixed_open_slots(), device=dev).expand(B, self.n_passages)
        else:
            open_idx = torch.randint(0, self.n_boxes - 1, (B, self.n_passages), generator=generator, device=dev)

        for k, passage in enumerate(self.non_collide_passages):
            state = passage.set_rendering(state, False)
            state = passage.set_pos(state, self._slot_pos(open_idx[:, k].to(torch.float32)))

        # the closed passages take the unblocked slots in ascending order
        # (overflow slots included)
        n_total = self.n_boxes + self.n_passages
        arr = torch.arange(n_total, device=dev)
        blocked = (arr[None, :, None] == open_idx[:, None, :]).any(-1)  # [B, n_total]
        order = torch.argsort(torch.where(blocked, n_total + arr, arr), dim=-1, stable=True)
        for k, passage in enumerate(self.collide_passages):
            state = passage.set_pos(state, self._slot_pos(order[:, k].to(torch.float32)))
        return state

    def spawn_walls(self, state):
        dev = state.device
        for i, wall in enumerate(self.walls):
            x = 0.0 if i % 2 else (1 + self.agent_radius if i == 0 else -1 - self.agent_radius)
            y = 0.0 if not i % 2 else (1 + self.agent_radius if i == 1 else -1 - self.agent_radius)
            state = wall.set_pos(state, torch.tensor([x, y], dtype=torch.float32, device=dev))
            state = wall.set_rot(state, torch.tensor(math.pi / 2 if not i % 2 else 0.0, dtype=torch.float32,
                                                     device=dev))
        return state

    # ------------------------------------------------------------------
    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device

        def uniform(shape, lo, hi):
            return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

        lim_s = math.pi / 2 if self.random_start_angle else 0.0
        lim_g = math.pi / 2 if self.random_goal_angle else 0.0
        start_angle = uniform((B,), -lim_s, lim_s)
        goal_angle = uniform((B,), -lim_g, lim_g)

        half = self.joint_length / 2
        sdx, sdy = half * torch.cos(start_angle), half * torch.sin(start_angle)
        gdx, gdy = half * torch.cos(goal_angle), half * torch.sin(goal_angle)

        min_x_s = -1 + (self.agent_radius + torch.abs(sdx))
        max_x_s = 1 - (self.agent_radius + torch.abs(sdx))
        min_y_s = -1 + (self.agent_radius + torch.abs(sdy))
        max_y_s = -2 * self.agent_radius - self.passage_width / 2 - torch.abs(sdy)
        min_x_g = -1 + (self.agent_radius + torch.abs(gdx))
        max_x_g = 1 - (self.agent_radius + torch.abs(gdx))
        min_y_g = 2 * self.agent_radius + self.passage_width / 2 + torch.abs(gdy)
        max_y_g = 1 - (self.agent_radius + torch.abs(gdy))

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
        swap = torch.rand((B,), generator=generator, device=dev) < 0.5
        sign = torch.where(swap, -1.0, 1.0)[:, None]
        for agent in self.world.agents:
            state = self.controllers[agent.name].reset(state)
        state = self.world.agents[0].set_pos(state, joint_pos - sign * delta)
        state = self.world.agents[1].set_pos(state, joint_pos + sign * delta)
        if self.asym_package:
            state = self.mass.set_pos(state, joint_pos + self.mass_position * delta * sign)

        state = self.spawn_passage_map(state, generator)
        state = self.spawn_walls(state)
        state = self.world.sync_joints(state)

        jl = self.joint.landmark
        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch = dict(state.scenario)
        scratch["passed"] = zeros
        scratch["pos_shaping_pre"] = self._dist_to_passages(state) * self.pos_shaping_factor
        scratch["pos_shaping_post"] = safe_norm(jl.pos(state) - goal_pos) * self.pos_shaping_factor
        scratch["rot_shaping_pre"] = _angle_dist(jl.rot(state), self.middle_angle) * self.rot_shaping_factor
        scratch["rot_shaping_post"] = _angle_dist(jl.rot(state), goal_angle) * self.rot_shaping_factor
        for k in ["rew", "pos_rew", "rot_rew", "collision_rew", "energy_rew"]:
            scratch[k] = zeros
        scratch["just_passed"] = torch.zeros((B,), dtype=torch.bool, device=dev)
        return state.replace(scenario=scratch)

    def _dist_to_passages(self, state):
        """The bar's distance to the nearest open passage: [B]."""
        jl = self.joint.landmark
        d = torch.stack([safe_norm(jl.pos(state) - p.pos(state)) for p in self.non_collide_passages], dim=1)
        return d.min(dim=1).values

    # ------------------------------------------------------------------
    def process_action(self, agent, state):
        if self.use_controller:
            vc = self.controllers[agent.name]
            state = vc.reset(state, env_mask=safe_norm(agent.u(state)) < 1e-3)
            return vc.process_force(state)
        return state

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        B, dev = state.batch_dim, state.device
        jl = self.joint.landmark
        zero = torch.zeros((B,), dtype=torch.float32, device=dev)
        joint_passed = jl.pos(state)[:, Y] > 0
        all_passed = (
            torch.stack([a.pos(state)[:, Y] for a in self.world.agents], dim=1) > self.passage_width / 2
        ).all(dim=1)

        shaping = self._dist_to_passages(state) * self.pos_shaping_factor
        pos_rew = torch.where(~joint_passed, scratch["pos_shaping_pre"] - shaping, zero)
        scratch["pos_shaping_pre"] = shaping

        shaping = safe_norm(jl.pos(state) - self.goal.pos(state)) * self.pos_shaping_factor
        pos_rew = pos_rew + torch.where(joint_passed, scratch["pos_shaping_post"] - shaping, zero)
        scratch["pos_shaping_post"] = shaping

        rot_passed = all_passed if self.all_passed_rot else joint_passed
        shaping = _angle_dist(jl.rot(state), self.middle_angle) * self.rot_shaping_factor
        rot_rew = torch.where(~rot_passed, scratch["rot_shaping_pre"] - shaping, zero)
        scratch["rot_shaping_pre"] = shaping

        shaping = _angle_dist(jl.rot(state), self.goal.rot(state)) * self.rot_shaping_factor
        rot_rew = rot_rew + torch.where(rot_passed, scratch["rot_shaping_post"] - shaping, zero)
        scratch["rot_shaping_post"] = shaping

        coll = zero
        if self.collision_reward != 0:
            bodies = self.world.agents + ([self.mass] if self.asym_package else [])
            for a in bodies:
                for p in self.collide_passages + self.walls:
                    hit = self.world.get_distance(state, a, p) <= self.min_collision_distance
                    coll = coll + self.collision_reward * hit.to(torch.float32)
            for p in self.collide_passages:
                hit = self.world.get_distance(state, p, jl) <= self.min_collision_distance
                coll = coll + self.collision_reward * hit.to(torch.float32)

        energy_rew = zero
        if self.energy_reward_coeff != 0:
            energy = torch.stack(
                [safe_norm(a.u(state)) / math.sqrt(self.world.dim_p * (0.8**2)) for a in self.world.agents], dim=1
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
        parts = [
            agent.pos(state),
            agent.vel(state),
            agent.pos(state) - self.goal.pos(state),
            *[agent.pos(state) - p.pos(state) for p in self.non_collide_passages],
            _angle_to_vector(self.goal.rot(state)),
        ]
        joint_angle = self.joint.landmark.rot(state) if self.observe_joint_angle else None
        return self._noisy(agent, parts, joint_angle)

    def done(self, state):
        jl = self.joint.landmark
        return (safe_norm(jl.pos(state) - self.goal.pos(state)) <= 0.01) & (
            _angle_dist(jl.rot(state), self.goal.rot(state)) <= 0.01
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
        return JointPassageOutputs(self, world)

    def extra_render(self, env, ax, env_index: int = 0):
        """Goal discs at the two ends of the goal bar."""
        import numpy as np

        from vmas_tpu_torch.render import draw

        p = self.goal.pos(env.state)[env_index].numpy()
        r = float(self.goal.rot(env.state)[env_index].reshape(-1)[0])
        d = self.joint_length / 2 * np.array([np.cos(r), np.sin(r)])
        for end in (p - d, p + d):
            draw.draw_circle(ax, end, self.agent_radius, self.goal.color, filled=True)


class JointPassageOutputs(F.FusedOutputs):
    """joint_passage's observations, reward and done as extra rows of the
    fused step. ``emit`` mirrors pre_rewards/observation/done line for line
    (the plain version); the kernel's JointPassageEmit computes the same
    rows on the device from the constants of ``kernel_emit``.

    Rows: per agent pos, vel, pos - goal, pos - each open passage, the
    goal's direction (cos, sin) and, if observed, the bar's raw rotation
    (``obs_w``); then rew, pos_rew, rot_rew, the four new shapings, passed,
    just_passed and done (10). Scratch in: pos_shaping_pre,
    pos_shaping_post, rot_shaping_pre, rot_shaping_post, passed; each
    carried from its emit row. With ``use_controller=True`` the rows step
    runs the velocity controller in the kernel (``fused.PidActRows``,
    without the input clamp and zeroing of give_way's): 4 controller rows
    per agent in the carry, the controller's output in 2 rows per agent
    after each step's emit rows. The observation noise is drawn in
    ``unpack`` from the same streams as ``observation``'s."""

    n_scratch_in = 5

    def __init__(self, scenario, world):
        self.scenario = scenario
        self.agent_i = [a.index for a in world.policy_agents]
        self.n_agents = A = len(self.agent_i)
        self.jl_i = scenario.joint.landmark.index
        self.goal_i = scenario.goal.index
        self.open_i = [p.index for p in scenario.non_collide_passages]
        self.pw_half = scenario.passage_width / 2
        self.pos_f = float(scenario.pos_shaping_factor)
        self.rot_f = float(scenario.rot_shaping_factor)
        self.middle = float(scenario.middle_angle)
        self.all_rot = bool(scenario.all_passed_rot)
        self.obs_joint = bool(scenario.observe_joint_angle)
        self.obs_w = 6 + 2 * len(self.open_i) + 2 + (1 if self.obs_joint else 0)
        self.base = A * self.obs_w
        self.n_out = self.base + 10
        # with the controller off, process_action does nothing; the noisy
        # configs read per-step noise in unpack
        self.process_action_noop = not scenario.use_controller
        self.unpack_reads = ("obs_key",) if (scenario.obs_noise > 0 or scenario.joint_angle_obs_noise > 0) else ()
        self.carry_extra_idx = tuple(self.base + 3 + k for k in range(5))
        if scenario.use_controller:
            self.attach_pid(F.PidActRows(world.policy_agents, scenario.controllers))
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        s = state.scenario
        return torch.stack(
            [s["pos_shaping_pre"], s["pos_shaping_post"], s["rot_shaping_pre"], s["rot_shaping_post"], s["passed"]]
        )

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rot = ctx["rot"]
        pp_pre, pp_post, rp_pre, rp_post, passed = ctx["scratch"]
        jl, gi = self.jl_i, self.goal_i

        joint_passed = py[jl] > 0
        all_passed = None
        for ai in self.agent_i:
            ok = py[ai] > self.pw_half
            all_passed = ok if all_passed is None else (all_passed & ok)

        dist_pass = None
        for pi in self.open_i:
            d = F._norm(px[jl] - px[pi], py[jl] - py[pi])
            dist_pass = d if dist_pass is None else torch.minimum(dist_pass, d)
        shaping = dist_pass * self.pos_f
        pos_rew = torch.where(~joint_passed, pp_pre - shaping, 0.0)
        pp_pre_new = shaping

        dist_goal = F._norm(px[jl] - px[gi], py[jl] - py[gi])
        shaping = dist_goal * self.pos_f
        pos_rew = pos_rew + torch.where(joint_passed, pp_post - shaping, 0.0)
        pp_post_new = shaping

        rot_passed = all_passed if self.all_rot else joint_passed
        shaping = _angle_dist(rot[jl], self.middle) * self.rot_f
        rot_rew = torch.where(~rot_passed, rp_pre - shaping, 0.0)
        rp_pre_new = shaping
        dist_rot_goal = _angle_dist(rot[jl], rot[gi])
        shaping = dist_rot_goal * self.rot_f
        rot_rew = rot_rew + torch.where(rot_passed, rp_post - shaping, 0.0)
        rp_post_new = shaping

        rew = pos_rew + rot_rew
        just_passed = all_passed & (passed == 0)
        passed_new = torch.where(just_passed, 100.0, passed)
        done = (dist_goal <= 0.01) & (dist_rot_goal <= 0.01)

        rows = []
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai], px[ai] - px[gi], py[ai] - py[gi]]
            for pi in self.open_i:
                rows += [px[ai] - px[pi], py[ai] - py[pi]]
            rows += [torch.cos(rot[gi]), torch.sin(rot[gi])]
            if self.obs_joint:
                rows.append(rot[jl])  # raw; unpack adds the noise
        rows += [rew, pos_rew, rot_rew, pp_pre_new, pp_post_new, rp_pre_new, rp_post_new, passed_new,
                 just_passed.to(torch.float32), done.to(torch.float32)]
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through (noise-free configs
        only: the noise streams are per step)."""
        A, w, base = self.n_agents, self.obs_w, self.base
        row = lambda r: extra[..., r, :]
        obs = []
        for i in range(A):
            o = extra[..., i * w:(i + 1) * w, :].transpose(-1, -2)  # [..., B, obs_w]
            n_parts = 4 + len(self.open_i)
            parts = [o[..., 2 * k:2 * k + 2] for k in range(n_parts)]
            if self.unpack_reads:
                joint_angle = o[..., 2 * n_parts] if self.obs_joint else None
                obs.append(self.scenario._noisy(self.scenario.world.policy_agents[i], parts, joint_angle))
            else:
                if self.obs_joint:
                    parts.append(_angle_to_vector(o[..., 2 * n_parts]))
                obs.append(torch.cat(parts, dim=-1))
        rew = row(base)
        zeros = torch.zeros_like(rew)
        updates = {
            "rew": rew, "pos_rew": row(base + 1), "rot_rew": row(base + 2),
            "collision_rew": zeros, "energy_rew": zeros,
            "pos_shaping_pre": row(base + 3), "pos_shaping_post": row(base + 4),
            "rot_shaping_pre": row(base + 5), "rot_shaping_post": row(base + 6),
            "passed": row(base + 7), "just_passed": row(base + 8) > 0.5,
        }
        return tuple(obs), tuple(rew for _ in range(A)), row(base + 9) > 0.5, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A or len(self.open_i) > K.MAX_E:
                raise NotImplementedError(
                    f"the fused kernel's joint_passage emit takes at most {K.MAX_A} agents and {K.MAX_E} open passages"
                )
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = ei
            p = ep.joint_passage
            p.n_agents = self.n_agents
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            p.jl, p.goal = self.jl_i, self.goal_i
            p.n_open = len(self.open_i)
            for k, pi in enumerate(self.open_i):
                p.open[k] = pi
            p.pw_half, p.pos_f, p.rot_f, p.middle = self.pw_half, self.pos_f, self.rot_f, self.middle
            p.all_rot, p.obs_joint = self.all_rot, self.obs_joint
            self._kernel_emit = (K.EMIT_JOINT_PASSAGE, ep)
        return self._kernel_emit
