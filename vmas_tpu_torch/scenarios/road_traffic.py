"""Road traffic scenario (CPM-lab map, kinematic-bicycle vehicles).

Counterpart of vmas_tpu/scenarios/road_traffic.py. The XML map and its
reference paths are packed into dense padded arrays at build time
(road_traffic_map.py); per-agent path data is gathered by ``path_id``; the
per-agent reward and observation loops are ``[B, A]`` tensor code.

Two kernels serve the default configuration (road_traffic_kernel.py, CUDA
in ``csrc/road_traffic.cu``): ``pallas_sweeps`` runs the path sweeps of
``_update_distances`` as one launch, and ``pallas_obs`` the all-ego
observations. The flag names are the JAX package's; here they mean "use the
CUDA kernel" (on CPU tensors the kernels' plain versions run). With both
off, the plain helpers below run instead, and stay differentiable.

Every configuration is ported: ``map_type`` "1" (the whole map), "2" (the
whole map, with a per-env state-history ring and the challenging
initial-state buffer, ISB, which records the lead-up to agent collisions
and replays it at resets) and "3" (one of three sub-maps per env, drawn by
``scenario_probabilities``, with per-agent resets at entries, exits and,
outside testing mode, no resets in envs that collided), and
``is_testing_mode`` (per-agent resets after any collision). The per-agent
resets of map 3 and testing mode run in ``post_rewards`` and refresh the
distances again, so ``_update_distances`` (the sweep kernel) runs twice a
step there. The per-step draws (those resets, the ISB's record gate) come
from a ``torch.Generator`` seeded from the seed the environment draws for
each step (``obs_generator(STEP_STREAM)``), so a rollout reproduces
``env.step``. Rendering (``extra_render``) is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vmas_tpu_torch.core import Agent, Box, World
from vmas_tpu_torch.core.utils import resolve_device, safe_norm
from vmas_tpu_torch.dynamics import KinematicBicycle
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk
from vmas_tpu_torch.scenarios import road_traffic_map as rtm
from vmas_tpu_torch.utils import ScenarioUtils

# the stream of the per-step draws (BaseScenario.obs_generator): above any
# agent's slot, whose stream draws its observation noise
STEP_STREAM = 1000


def exponential_decreasing_fcn(x, x0, x1):
    """1 at x0, decaying to 0 at x1 (clipped outside)."""
    xc = torch.clamp(x, x0, x1)
    e = math.e
    return (torch.exp(-(xc - x0) / (x1 - x0)) - 1 / e) / (1 - 1 / e)


def angle_eliminate_two_pi(angle):
    """Wrap to (-pi, pi]; floor-mod, as jnp.mod."""
    a = torch.remainder(angle, 2 * math.pi)
    return torch.where(a > math.pi, a - 2 * math.pi, a)


def rectangle_vertices(center, yaw, width, length):
    """[..., 5, 2] closed rectangle, in the sweep kernel's arithmetic."""
    xs, ys = rtk.rect_vertices_xy(center[..., 0], center[..., 1], yaw, length / 2, width / 2)
    return torch.stack([torch.stack(xs, -1), torch.stack(ys, -1)], -1)


def perpendicular_distances(point, polyline, n_points):
    """Min distance from point [..., 2] to padded polyline [..., M, 2];
    segments at or after ``n_points - 1`` inherit the end segment's
    distance. Returns (dist, first-min index + 1)."""
    sx = polyline[..., :-1, 0]
    sy = polyline[..., :-1, 1]
    vx = polyline[..., 1:, 0] - sx
    vy = polyline[..., 1:, 1] - sy
    px = point[..., 0:1]
    py = point[..., 1:2]
    pvx = px - sx
    pvy = py - sy
    ll = vx * vx + vy * vy + 1e-8
    t = torch.clamp((pvx * vx + pvy * vy) / ll, 0, 1)
    dx = (sx + vx * t) - px
    dy = (sy + vy * t) - py
    sq = dx * dx + dy * dy
    d = torch.where(sq == 0.0, 0.0, torch.sqrt(torch.where(sq == 0.0, 1.0, sq)))  # [..., M-1]
    seg_idx = torch.arange(d.shape[-1], device=d.device)
    end_seg = torch.clamp(n_points - 2, min=0)[..., None].expand(d.shape[:-1] + (1,))
    end_d = torch.gather(d, -1, end_seg)
    d = torch.where(seg_idx >= (n_points - 1)[..., None], end_d, d)
    idx = torch.argmin(d, dim=-1)  # the first index of the minimum
    return d.min(-1).values, idx + 1


def short_term_path(polyline, idx_closest, n_return, is_loop, n_points,
                    sample_interval, n_points_shift):
    """``n_return`` points of ``polyline`` ahead of ``idx_closest``
    ([..., n_return, 2]), wrapping on loops; a negative index counts from
    the end of the padded polyline."""
    fut = (
        torch.arange(n_return, device=idx_closest.device) * sample_interval
        + idx_closest[..., None]
        + n_points_shift
    )
    n = n_points[..., None]
    fut = torch.where(is_loop[..., None] & (fut >= n - 1), torch.remainder(fut + 1, n), fut)
    M = polyline.shape[-2]
    fut = torch.where(fut < 0, M + fut, fut)
    fut = torch.clamp(fut, 0, M - 1)
    return torch.gather(polyline, -2, fut[..., None].expand(fut.shape + (2,))), fut


def interX_any(L1, L2):
    """Batched polyline-intersection test. L1 [..., n1, 2], L2 [..., n2, 2]
    -> bool [...]. Zero-length padding segments are inert."""
    x1, y1 = L1[..., 0], L1[..., 1]
    x2, y2 = L2[..., 0], L2[..., 1]
    dx1, dy1 = torch.diff(x1, dim=-1), torch.diff(y1, dim=-1)
    dx2, dy2 = torch.diff(x2, dim=-1), torch.diff(y2, dim=-1)
    S1 = dx1 * y1[..., :-1] - dy1 * x1[..., :-1]
    S2 = dx2 * y2[..., :-1] - dy2 * x2[..., :-1]

    # C1[i, j]: does segment i of L1 straddle the line of values at L2 points
    v1 = dx1[..., :, None] * y2[..., None, :] - dy1[..., :, None] * x2[..., None, :]
    C1 = (v1[..., :-1] - S1[..., :, None]) * (v1[..., 1:] - S1[..., :, None]) < 0
    v2 = y1[..., :, None] * dx2[..., None, :] - x1[..., :, None] * dy2[..., None, :]
    C2 = (v2[..., :-1, :] - S2[..., None, :]) * (v2[..., 1:, :] - S2[..., None, :]) < 0
    return torch.any((C1 & C2).flatten(-2), dim=-1)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        device = resolve_device(device)
        self.init_params(batch_dim, device, **kwargs)
        world = World(
            batch_dim, device,
            x_semidim=self.world_x_dim, y_semidim=self.world_y_dim,
            dt=self.dt,
        )
        for i in range(self.n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    shape=Box(length=self.l_f + self.l_r, width=self.agent_width),
                    color=tuple(np.random.default_rng(i).uniform(0, 1, 3).tolist()),
                    collide=False,
                    u_range=[self.max_speed, self.max_steering_angle],
                    u_multiplier=[1, 1],
                    max_speed=self.max_speed,
                    dynamics=KinematicBicycle(
                        world, width=self.agent_width, l_f=self.l_f, l_r=self.l_r,
                        max_steering_angle=self.max_steering_angle, integration="rk4",
                    ),
                )
            )
        return world

    def init_params(self, batch_dim, device, **kwargs):
        self.world_x_dim = kwargs.pop("world_x_dim", 4.5)
        self.world_y_dim = kwargs.pop("world_y_dim", 4.0)
        self.agent_width = kwargs.pop("agent_width", 0.08)
        self.agent_length = kwargs.pop("agent_length", 0.16)
        self.l_f = kwargs.pop("l_f", self.agent_length / 2)
        self.l_r = kwargs.pop("l_r", self.agent_length - self.l_f)
        lane_width = kwargs.pop("lane_width", 0.15)

        r_p = 100
        self.reward_progress = kwargs.pop("reward_progress", 10) / r_p
        self.reward_vel = kwargs.pop("reward_vel", 5) / r_p
        self.reward_reach_goal = kwargs.pop("reward_reach_goal", 0) / r_p

        self.threshold_change_steering = math.radians(kwargs.pop("threshold_change_steering", 10))
        self.threshold_near_boundary_high = kwargs.pop(
            "threshold_near_boundary_high", (lane_width - self.agent_width) / 2 * 0.9
        )
        self.threshold_near_boundary_low = kwargs.pop("threshold_near_boundary_low", 0)
        self.threshold_near_agents_high = kwargs.pop(
            "threshold_near_other_agents_c2c_high", self.agent_length + self.agent_width
        )
        self.threshold_near_agents_low = kwargs.pop(
            "threshold_near_other_agents_c2c_low", (self.agent_length + self.agent_width) / 2
        )

        self.sample_interval = int(kwargs.pop("sample_interval_ref_path", 2))
        self.noise_level = kwargs.pop("noise_level", 0.2 * self.agent_width)
        self.max_steering_angle = float(kwargs.pop("max_steering_angle", math.radians(35)))
        self.max_speed = kwargs.pop("max_speed", 1.0)

        self.n_agents = kwargs.pop("n_agents", 20)
        self.is_partial_observation = kwargs.pop("is_partial_observation", True)
        self.is_testing_mode = kwargs.pop("is_testing_mode", False)
        self.map_type = str(kwargs.pop("map_type", "1"))
        self.n_nearing_agents = kwargs.pop("n_nearing_agents_observed", 2)
        self.n_points_short_term = kwargs.pop("n_points_short_term", 3)
        self.dt = kwargs.pop("dt", 0.05)
        self.is_ego_view = kwargs.pop("is_ego_view", True)
        self.is_apply_mask = kwargs.pop("is_apply_mask", True)
        self.is_observe_vertices = kwargs.pop("is_observe_vertices", True)
        self.is_observe_distance_to_agents = kwargs.pop("is_observe_distance_to_agents", True)
        self.is_observe_distance_to_boundaries = kwargs.pop("is_observe_distance_to_boundaries", True)
        self.is_observe_distance_to_center_line = kwargs.pop("is_observe_distance_to_center_line", True)
        self.scenario_probabilities = kwargs.pop("scenario_probabilities", [1.0, 0.0, 0.0])
        if self.map_type == "3":
            # the sub-maps cannot host more vehicles
            if self.scenario_probabilities[1] != 0 or self.scenario_probabilities[2] != 0:
                if self.n_agents > 5:
                    raise ValueError(
                        "For map_type '3', if the second or third value of scenario_probabilities is not "
                        "zero, a maximum of 5 agents are allowed."
                    )
            elif self.n_agents > 10:
                raise ValueError(
                    "For map_type '3', if only the first value of scenario_probabilities is not zero, a "
                    "maximum of 10 agents are allowed."
                )
        self.is_add_noise = kwargs.pop("is_add_noise", True)
        self.is_observe_ref_path_other_agents = kwargs.pop("is_observe_ref_path_other_agents", False)
        self.n_steps_stored = kwargs.pop("n_steps_stored", 10)
        self.isb_capacity = kwargs.pop("buffer_size", 100)
        self.probability_record = kwargs.pop("probability_record", 1.0)
        self.n_steps_before_recording = kwargs.pop("n_steps_before_recording", 10)
        self.n_points_nearing_boundary = kwargs.pop("n_points_nearing_boundary", 5)
        self.probability_use_recording = kwargs.pop("probability_use_recording", 0.2)
        map_file_path = kwargs.pop("map_file_path", None)
        # the path-sweep kernel and the all-ego observation kernel
        # (road_traffic_kernel.py): forward-only, so Environment turns both
        # off under grad_enabled
        self.pallas_sweeps = bool(kwargs.pop("pallas_sweeps", True))
        self.pallas_obs = bool(kwargs.pop("pallas_obs", True))
        # accepted as the JAX package accepts them; read there only by what
        # is not ported (rendering) or not at all
        for k in (
            "threshold_deviate_from_ref_path", "threshold_reach_goal",
            "threshold_no_reward_if_too_close_to_boundaries",
            "threshold_no_reward_if_too_close_to_other_agents", "resolution_factor",
            "max_ref_path_points", "n_stored_steps", "n_observed_steps", "render_origin",
            "viewer_size", "viewer_zoom", "is_visualize_short_term_path", "is_real_time_rendering",
            "is_visualize_extra_info", "render_title", "parameters",
        ):
            kwargs.pop(k, None)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        if self.n_nearing_agents >= self.n_agents:
            raise ValueError("n_nearing_agents_observed must be less than n_agents")

        # map + packed reference paths: the whole map's, or map 3's three
        # sub-maps' one after the other (intersection, merge-in, merge-out)
        self.map_data = rtm.parse_map(map_file_path)
        paths_all, paths_inter, paths_mi, paths_mo = rtm.build_reference_paths(self.map_data)
        n_extend = self.n_points_short_term * self.sample_interval
        if self.map_type in ("1", "2"):
            self.paths = rtm.pad_paths(paths_all, n_extend)
            self.section_offsets = [0, len(paths_all)]
        else:
            combined = paths_inter + paths_mi + paths_mo
            self.paths = rtm.pad_paths(combined, n_extend)
            self.section_offsets = [0, len(paths_inter), len(paths_inter) + len(paths_mi), len(combined)]
        p = self.paths
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=device)
        self.P = dict(
            center=f32(p.center), yaw=f32(p.yaw), left_b=f32(p.left_b), right_b=f32(p.right_b),
            entry=f32(p.entry), exit=f32(p.exit),
            n_points=i64(p.n_points), n_left=i64(p.n_left), n_right=i64(p.n_right),
            is_loop=torch.tensor(p.is_loop, device=device),
        )
        self._sweep_tables = rtk.build_tables(p, device)
        self._offsets = i64(self.section_offsets)
        # map 3's sub-map draw: u in [0, 1) picks sub-map k + 1 past the
        # first k of these cumulative probabilities
        probs = np.asarray(self.scenario_probabilities, np.float64)
        self._scenario_cdf = torch.tensor((np.cumsum(probs) / probs.sum())[:-1], dtype=torch.float32, device=device)

        # normalizers
        self.norm_pos = self.agent_length * 10
        self.norm_pos_world = torch.tensor([self.world_x_dim, self.world_y_dim], device=device)
        self.norm_v = self.max_speed
        self.norm_rot = 2 * math.pi
        self.norm_action_steering = self.max_steering_angle
        self.norm_action_vel = self.max_speed
        self.norm_distance_lanelet = lane_width * 3
        self.norm_distance_ref = lane_width * 3

        # penalties
        self.penalty_deviate = -2 / 100
        self.weighting_deviate = self.map_data["mean_lane_width"] / 2
        self.penalty_near_boundary = -20 / 100
        self.penalty_near_agents = -20 / 100
        self.penalty_collide_agents = -100 / 100
        self.penalty_collide_boundaries = -100 / 100
        self.penalty_change_steering = -2 / 100
        self.penalty_time = 5 / 100

        w = np.linspace(1, 0.2, self.n_points_short_term, dtype=np.float32)
        self.weighting_ref_directions = torch.tensor(w / w.sum(), device=device)
        self.threshold_mask_agents = float(np.float32(self.norm_pos))
        self.reset_agent_min_distance = math.sqrt((self.l_f + self.l_r) ** 2 + self.agent_width**2) * 1.2
        self._pairs = tuple(torch.tensor(ix, device=device) for ix in np.triu_indices(self.n_agents, k=1))
        # the kernels' static arguments
        self.sweep_kw = dict(
            lh=(self.l_f + self.l_r) / 2, wh=self.agent_width / 2, S=int(self.n_points_short_term),
            interval=int(self.sample_interval), shift=1,
        )
        self.obs_kw = dict(
            K=self.n_nearing_agents, apply_mask=self.is_apply_mask,
            # norm_pos == threshold_mask_agents by construction
            norm_pos=self.threshold_mask_agents, norm_v=float(self.norm_v),
            norm_dist=float(self.norm_distance_lanelet), thresh=self.threshold_mask_agents,
        )

    # ------------------------------------------------------------------
    def _agent_arrays(self, state):
        a_idx = [a.index for a in self.world.agents]
        return state.pos[:, a_idx], state.rot[:, a_idx], state.vel[:, a_idx]

    def _draw_scenario_id(self, generator, B, device):
        """[B] int64: each env's sub-map, 1, 2 or 3 by
        ``scenario_probabilities`` on map 3 (one uniform draw per env
        against the cumulative probabilities); 0 on maps 1 and 2, with no
        draw."""
        if self.map_type != "3":
            return torch.zeros((B,), dtype=torch.int64, device=device)
        u = torch.rand((B,), generator=generator, device=device)
        return (u[:, None] >= self._scenario_cdf[None]).sum(-1) + 1

    def _sample_path_and_point(self, generator, sid):
        """Draw (path_id, point_id) [B] for one agent: its path among all
        paths on maps 1 and 2, among its sub-map's (``sid`` [B]) on map 3,
        and a point on it."""
        B, dev = sid.shape[0], sid.device
        if self.map_type in ("1", "2"):
            path_id = torch.randint(0, self.P["center"].shape[0], (B,), generator=generator, device=dev)
        else:
            lo, hi = self._offsets[sid - 1], self._offsets[sid]
            u = torch.rand((B,), generator=generator, device=dev)
            path_id = lo + torch.floor(u * (hi - lo)).long()
        n_pts = self.P["n_points"][path_id]
        u2 = torch.rand((B,), generator=generator, device=dev)
        if self.scenario_probabilities[1] == 0 and self.scenario_probabilities[2] == 0:
            lo_p, hi_p = 6, torch.div(n_pts, 2, rounding_mode="trunc")
        else:
            lo_p, hi_p = 3, n_pts - 5
        point_id = lo_p + torch.floor(u2 * (hi_p - lo_p)).long()
        return path_id, point_id

    def _place(self, generator, sid, p_i, pt_i, bad_envs):
        """Redraw (path, point) within ``sid`` in the envs where
        ``bad_envs(pos)`` holds, at most 100 times; returns (path_id,
        point_id, pos)."""
        center = self.P["center"]
        pos_i = center[p_i, pt_i]
        bad, tries = bad_envs(pos_i), 0
        while bool(bad.any()) and tries < 100:
            p2, pt2 = self._sample_path_and_point(generator, sid)
            p_i = torch.where(bad, p2, p_i)
            pt_i = torch.where(bad, pt2, pt_i)
            pos_i = center[p_i, pt_i]
            bad, tries = bad_envs(pos_i), tries + 1
        return p_i, pt_i, pos_i

    def _reset_agents_states(self, state, generator, agent_mask=None):
        """Place agents on their paths with a speed along them.

        Without ``agent_mask``, every agent of every env, one by one: agent
        i redraws (at most 100 times) in the envs where it lands too close
        to agents < i; on map 3 each env first draws its sub-map; on map 2,
        with probability ``probability_use_recording``, an env then takes a
        recorded state from the ISB instead. With ``agent_mask`` [B, A],
        only the masked agents, each within its own sub-map and kept clear
        of every other agent."""
        B, A, dev = state.batch_dim, self.n_agents, state.device
        yaw = self.P["yaw"]
        min_d2 = self.reset_agent_min_distance**2
        a_idx = [a.index for a in self.world.agents]
        scratch = dict(state.scenario)
        if agent_mask is None:
            sid_env = self._draw_scenario_id(generator, B, dev)
            sid = sid_env[:, None].expand(B, A).clone()
            pid = torch.zeros((B, A), dtype=torch.int64, device=dev)
            ptid = torch.zeros_like(pid)
            pos_all = torch.zeros((B, A, 2), device=dev)
            rot_all = torch.zeros((B, A), device=dev)
            vel_all = torch.zeros((B, A, 2), device=dev)
            agents = range(A)
        else:
            sid = scratch["scenario_id"]
            pid, ptid = scratch["path_id"].clone(), scratch["point_id"].clone()
            pos_all, rot_all, vel_all = (t.clone() for t in self._agent_arrays(state))
            # the agents reset in some env (one read of the mask)
            agents = [i for i, any_env in enumerate(agent_mask.any(0).tolist()) if any_env]
        for i in agents:
            p_i, pt_i = self._sample_path_and_point(generator, sid[:, i])
            if agent_mask is None:
                if i > 0:
                    def bad_envs(pos_c):
                        d2 = torch.sum((pos_all[:, :i] - pos_c[:, None]) ** 2, -1)
                        return torch.min(d2, -1).values < min_d2

                    p_i, pt_i, pos_i = self._place(generator, sid[:, i], p_i, pt_i, bad_envs)
                else:
                    pos_i = self.P["center"][p_i, pt_i]
                m = torch.ones((B,), dtype=torch.bool, device=dev)
            else:
                m = agent_mask[:, i]

                def bad_envs(pos_c):
                    d2 = torch.sum((pos_all - pos_c[:, None]) ** 2, -1)
                    d2[:, i] = torch.inf
                    return (torch.min(d2, -1).values < min_d2) & m

                p_i, pt_i, pos_i = self._place(generator, sid[:, i], p_i, pt_i, bad_envs)
            rot_i = yaw[p_i, pt_i]
            vmag = torch.rand((B,), generator=generator, device=dev) * self.max_speed
            vel_i = torch.stack([vmag * torch.cos(rot_i), vmag * torch.sin(rot_i)], -1)
            pos_all[:, i] = torch.where(m[:, None], pos_i, pos_all[:, i])
            rot_all[:, i] = torch.where(m, rot_i, rot_all[:, i])
            vel_all[:, i] = torch.where(m[:, None], vel_i, vel_all[:, i])
            pid[:, i] = torch.where(m, p_i, pid[:, i])
            ptid[:, i] = torch.where(m, pt_i, ptid[:, i])

        if self.map_type == "2" and agent_mask is None and "isb_size" in scratch:
            # replay a recorded near-collision lead-up in some envs
            size = torch.clamp(scratch["isb_size"], max=self.isb_capacity)
            use = (torch.rand((B,), generator=generator, device=dev) < self.probability_use_recording) & (size > 0)
            n_rec = torch.clamp(size, min=1)
            pick = torch.floor(torch.rand((B,), generator=generator, device=dev) * n_rec).long()
            rec = scratch["isb_buffer"][torch.minimum(pick, n_rec - 1)]  # [B, A, 8]
            u = use[:, None]
            pos_all = torch.where(u[..., None], rec[..., 0:2], pos_all)
            rot_all = torch.where(u, rec[..., 2], rot_all)
            vel_all = torch.where(u[..., None], rec[..., 3:5], vel_all)
            sid = torch.where(u, rec[..., 5].long(), sid)
            pid = torch.where(u, rec[..., 6].long(), pid)
            ptid = torch.where(u, rec[..., 7].long(), ptid)

        pos, rot, vel = state.pos.clone(), state.rot.clone(), state.vel.clone()
        pos[:, a_idx], rot[:, a_idx], vel[:, a_idx] = pos_all, rot_all, vel_all
        scratch["scenario_id"] = sid
        scratch["path_id"] = pid
        scratch["point_id"] = ptid
        return state.replace(pos=pos, rot=rot, vel=vel, scenario=scratch)

    def _update_distances(self, state, scratch):
        """Fresh distances, vertices and collision flags of the current
        state."""
        pos, rot, vel = self._agent_arrays(state)
        pid = scratch["path_id"]
        verts = rectangle_vertices(pos, rot, self.agent_width, self.l_f + self.l_r)
        P = self.P
        if self.pallas_sweeps:
            out = rtk.sweep_all(
                self._sweep_tables, pid.contiguous(), pos.contiguous(), rot.contiguous(), **self.sweep_kw
            )
            d_ref, idx_ref = out["d_ref"], out["idx_ref"]
            dl5, dr5 = out["dl5"], out["dr5"]
            idx_l, idx_r = out["idx_l"], out["idx_r"]
            coll_lanelets = out["coll_l"] | out["coll_r"]
            # the short-term path staged for _refresh_short_term
            scratch["st_next"] = out["short_term"]
        else:
            center, left_b, right_b = P["center"][pid], P["left_b"][pid], P["right_b"][pid]
            n_pts, n_l, n_r = P["n_points"][pid], P["n_left"][pid], P["n_right"][pid]
            # one batched sweep for the CG + 4 corners against each boundary
            pts = torch.cat([pos[:, :, None, :], verts[:, :, :4]], dim=2)  # [B, A, 5, 2]
            d_ref, idx_ref = perpendicular_distances(pos, center, n_pts)
            dl5, idx_l5 = perpendicular_distances(pts, left_b[:, :, None], n_l[:, :, None].expand(-1, -1, 5))
            dr5, idx_r5 = perpendicular_distances(pts, right_b[:, :, None], n_r[:, :, None].expand(-1, -1, 5))
            idx_l, idx_r = idx_l5[..., 0], idx_r5[..., 0]
            coll_lanelets = interX_any(verts, left_b) | interX_any(verts, right_b)
        d_left = torch.cat([dl5[..., :1] - self.agent_width / 2, dl5[..., 1:]], -1)
        d_right = torch.cat([dr5[..., :1] - self.agent_width / 2, dr5[..., 1:]], -1)
        d_bound = torch.minimum(d_left.min(-1).values, d_right.min(-1).values)

        # mutual c2c distances, diagonal lifted by the global maximum
        A = self.n_agents
        diff = pos[:, :, None] - pos[:, None]
        d_agents = torch.sqrt(torch.sum(diff * diff, -1) + 1e-12)
        d_agents = d_agents + torch.eye(A, device=pos.device)[None] * (d_agents.max() + 1)

        # agent-agent collisions: agent i's new rectangle against agent j's
        # (j > i) rectangle of the previous step, so a new contact is
        # flagged one step late, as in the reference's pair loop
        verts_prev = scratch.get("verts_prev", verts)
        ii, jj = self._pairs
        hits = interX_any(verts[:, ii], verts_prev[:, jj])  # [B, P]
        coll_agents = torch.zeros((state.batch_dim, A, A), dtype=torch.bool, device=pos.device)
        coll_agents[:, ii, jj] = hits
        coll_agents[:, jj, ii] = hits
        is_loop = P["is_loop"][pid]
        coll_entry = interX_any(verts, P["entry"][pid]) & ~is_loop
        coll_exit = interX_any(verts, P["exit"][pid]) & ~is_loop

        scratch.update(
            d_ref=d_ref, idx_ref=idx_ref, d_left=d_left, d_right=d_right,
            d_bound=d_bound, d_agents=d_agents, verts=verts, verts_prev=verts,
            coll_agents=coll_agents, coll_lanelets=coll_lanelets,
            coll_entry=coll_entry, coll_exit=coll_exit,
            idx_left=idx_l, idx_right=idx_r,
        )
        return scratch

    def _refresh_short_term(self, scratch, at_reset=False):
        P = self.P
        pid = scratch["path_id"]
        n_pts, is_loop = P["n_points"][pid], P["is_loop"][pid]
        if "st_next" in scratch:
            # staged by the sweep kernel in _update_distances, from the same
            # idx_ref with shift 1
            scratch["short_term"] = scratch["st_next"]
        else:
            scratch["short_term"], _ = short_term_path(
                P["center"][pid], scratch["idx_ref"], self.n_points_short_term, is_loop,
                n_pts, self.sample_interval, 1,
            )
        if not self.is_observe_distance_to_boundaries:
            # the centre line's n_points wraps the boundaries too; shift +1
            # at reset, -2 per step
            shift = 1 if at_reset else -2
            scratch["near_left_b"], _ = short_term_path(
                P["left_b"][pid], scratch["idx_left"], self.n_points_nearing_boundary,
                is_loop, n_pts, 1, shift,
            )
            scratch["near_right_b"], _ = short_term_path(
                P["right_b"][pid], scratch["idx_right"], self.n_points_nearing_boundary,
                is_loop, n_pts, 1, shift,
            )
        return scratch

    # ------------------------------------------------------------------
    def reset_world_at(self, state, generator):
        B, A = state.batch_dim, self.n_agents
        state = self._reset_agents_states(state, generator)
        scratch = self._update_distances(state, dict(state.scenario))
        scratch["short_term"] = torch.zeros((B, A, self.n_points_short_term, 2), device=state.device)
        scratch = self._refresh_short_term(scratch, at_reset=True)

        pos, rot, vel = self._agent_arrays(state)
        scratch["prev_pos"] = pos
        # past actions are not cleared on reset, so the first post-reset
        # steering penalty compares pre-reset actions
        zeros_a = torch.zeros((B, A), device=state.device)
        scratch["steering_cur"] = scratch.get("steering_cur", zeros_a)
        scratch["steering_prev"] = scratch.get("steering_prev", zeros_a)
        scratch["rew_all"] = zeros_a
        if self.is_testing_mode or self.map_type == "3":
            scratch["done_flags"] = torch.zeros((B,), dtype=torch.bool, device=state.device)
        if self.map_type == "2":
            # the ISB, with a trash row at index buffer_size for the envs a
            # step does not record; it has no env axis, so it carries over
            # partial resets (core/state.py blend: the fresh value, here the
            # old one, wins)
            scratch["isb_buffer"] = scratch.get(
                "isb_buffer", torch.zeros((self.isb_capacity + 1, A, 8), device=state.device))
            scratch["isb_size"] = scratch.get("isb_size", torch.zeros((), dtype=torch.int64, device=state.device))
            # the per-env state-history ring, seeded with the post-reset
            # state; 1 % H: on a one-slot ring the next write lands back on
            # slot 0
            H = self.n_steps_before_recording
            hist = torch.zeros((B, H, A, 8), device=state.device)
            hist[:, 0] = self._hist_entry(state, scratch)
            scratch["hist"] = hist
            scratch["hist_ptr"] = torch.full((B,), 1 % H, dtype=torch.int64, device=state.device)
            scratch["hist_valid"] = torch.ones((B,), dtype=torch.int64, device=state.device)
        return state.replace(scenario=scratch)

    # ------------------------------------------------------------------
    def pre_rewards(self, state):
        """All agents' rewards, after refreshing distances and collisions."""
        scratch = dict(state.scenario)
        scratch = self._update_distances(state, scratch)
        pos, rot, vel = self._agent_arrays(state)

        # forward-movement reward (the PREVIOUS short-term path and pos)
        move_vec = (pos - scratch["prev_pos"])[:, :, None, :]  # [B, A, 1, 2]
        ref_vecs = scratch["short_term"] - scratch["prev_pos"][:, :, None, :]
        move_proj = torch.sum(move_vec * ref_vecs, -1)  # [B, A, S]
        move_w = move_proj @ self.weighting_ref_directions  # [B, A]
        rew = move_w / (self.max_speed * self.dt) * self.reward_progress

        v_proj = torch.sum(vel[:, :, None, :] * ref_vecs, -1).mean(-1)
        factor = torch.where(v_proj > 0, 1.0, 2.0)
        rew = rew + factor * v_proj / self.max_speed * self.reward_vel
        rew = rew + scratch["coll_exit"] * self.reward_reach_goal

        rew = rew + exponential_decreasing_fcn(
            scratch["d_bound"], self.threshold_near_boundary_low, self.threshold_near_boundary_high
        ) * self.penalty_near_boundary
        near_agents = exponential_decreasing_fcn(
            scratch["d_agents"], self.threshold_near_agents_low, self.threshold_near_agents_high
        ).sum(-1)
        rew = rew + near_agents * self.penalty_near_agents
        rew = rew + scratch["d_ref"] / self.weighting_deviate * self.penalty_deviate

        steering_change = torch.clamp(
            torch.abs(scratch["steering_cur"] - scratch["steering_prev"]) * self.norm_action_steering
            - self.threshold_change_steering,
            min=0,
        )
        factor_steer = steering_change / (2 * self.max_steering_angle - 2 * self.threshold_change_steering)
        rew = rew + factor_steer * self.penalty_change_steering

        rew = rew + scratch["coll_agents"].any(-1) * self.penalty_collide_agents
        rew = rew + scratch["coll_lanelets"] * self.penalty_collide_boundaries
        rew = rew + torch.where(v_proj > 0, 1.0, -1.0) * safe_norm(vel) / self.max_speed * self.penalty_time
        scratch["rew_all"] = rew
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["rew_all"][:, agent.slot]

    def post_rewards(self, state):
        """Refresh the short-term paths, keep this step's positions and
        steering actions for the next step's reward; on map 2, push the
        state into the history ring and record colliding envs' lead-up in
        the ISB; on map 3 and in testing mode, the per-agent resets."""
        scratch = dict(state.scenario)
        scratch = self._refresh_short_term(scratch)
        pos, rot, vel = self._agent_arrays(state)
        scratch["prev_pos"] = pos
        u = torch.stack([a.u(state) for a in self.world.agents], dim=1)  # [B, A, 2]
        scratch["steering_prev"] = scratch["steering_cur"]
        scratch["steering_cur"] = u[..., 1] / self.norm_action_steering
        state = state.replace(scenario=scratch)
        if self.map_type != "2" and not (self.is_testing_mode or self.map_type == "3"):
            return state

        generator = self.obs_generator(STEP_STREAM)
        if self.map_type == "2":
            # the reward phase appends to the history, then the ISB records
            # the lead-up of the envs whose agents collided
            state = self._hist_push(state)
            state = self._isb_record(state, generator)
            scratch = dict(state.scenario)

        if self.is_testing_mode or self.map_type == "3":
            B = state.batch_dim
            # done sees the reward phase's collision flags, not those after
            # the resets below
            is_done = (
                torch.zeros((B,), dtype=torch.bool, device=state.device)
                if self.is_testing_mode
                else scratch["coll_agents"].reshape(B, -1).any(-1) | scratch["coll_lanelets"].any(-1)
            )
            scratch["done_flags"] = is_done
            agents_reset = scratch["coll_entry"] | scratch["coll_exit"]
            if self.is_testing_mode:
                agents_reset = scratch["coll_agents"].any(-1) | scratch["coll_lanelets"] | agents_reset
            else:
                # map 3 resets no agent in an env that is done
                agents_reset = agents_reset & ~is_done[:, None]
            state = state.replace(scenario=scratch)
            state = self._reset_agents_states(state, generator, agent_mask=agents_reset)
            scratch = self._update_distances(state, dict(state.scenario))
            scratch = self._refresh_short_term(scratch)
            if not self.is_observe_distance_to_boundaries:
                # the agents just reset take the reset's +1 nearing shift
                reset_near = self._refresh_short_term(dict(scratch), at_reset=True)
                m = agents_reset[..., None, None]
                scratch["near_left_b"] = torch.where(m, reset_near["near_left_b"], scratch["near_left_b"])
                scratch["near_right_b"] = torch.where(m, reset_near["near_right_b"], scratch["near_right_b"])
            # a reset agent's next movement reward measures from where it
            # was placed
            pos_new, _, _ = self._agent_arrays(state)
            scratch["prev_pos"] = torch.where(agents_reset[..., None], pos_new, scratch["prev_pos"])
            if self.map_type == "2":
                scratch = self._hist_reseed(scratch, state, agents_reset.any(-1))
            state = state.replace(scenario=scratch)
        return state

    def _hist_entry(self, state, scratch):
        """One history record [B, A, 8]: pos, rot, vel and the scenario,
        path and point ids."""
        pos, rot, vel = self._agent_arrays(state)
        ids = [scratch[k][..., None].to(torch.float32) for k in ("scenario_id", "path_id", "point_id")]
        return torch.cat([pos, rot[..., None], vel, *ids], dim=-1)

    def _hist_push(self, state):
        """Write the current state into each env's history ring."""
        scratch = dict(state.scenario)
        B, H = state.batch_dim, self.n_steps_before_recording
        ptr = scratch["hist_ptr"]
        hist = scratch["hist"].clone()
        hist[torch.arange(B, device=state.device), ptr] = self._hist_entry(state, scratch)
        scratch["hist"] = hist
        scratch["hist_ptr"] = (ptr + 1) % H
        scratch["hist_valid"] = torch.clamp(scratch["hist_valid"] + 1, max=H)
        return state.replace(scenario=scratch)

    def _hist_reseed(self, scratch, state, env_reset):
        """Wipe the history rings of the envs in ``env_reset`` [B] and seed
        them with the current (post-reset) state. The reference's single
        buffer is wiped for every env on any reset; per-env rings keep the
        other envs' lead-up."""
        fresh = torch.zeros_like(scratch["hist"])
        fresh[:, 0] = self._hist_entry(state, scratch)
        scratch["hist"] = torch.where(env_reset[:, None, None, None], fresh, scratch["hist"])
        H = self.n_steps_before_recording
        scratch["hist_ptr"] = torch.where(env_reset, 1 % H, scratch["hist_ptr"])
        scratch["hist_valid"] = torch.where(env_reset, 1, scratch["hist_valid"])
        return scratch

    def _isb_record(self, state, generator):
        """Record in the ISB, for each env whose agents collided, its state
        ``n_steps_stored`` steps ago from its history ring (slot 0, the
        post-reset seed, while fewer steps have passed), gated for the whole
        batch by one draw against ``probability_record``. Lanelet scrapes
        are not recorded. Where more envs record than the buffer holds, the
        last ``buffer_size`` of them in env order survive; the others write
        the trash row, which keeps the kept writes' indices distinct."""
        scratch = dict(state.scenario)
        B, dev = state.batch_dim, state.device
        is_coll = scratch["coll_agents"].reshape(B, -1).any(-1)
        gate = torch.rand((), generator=generator, device=dev) < self.probability_record
        rec = is_coll & gate  # [B]
        n, H, cap = self.n_steps_stored, self.n_steps_before_recording, self.isb_capacity
        idx = torch.where(n > scratch["hist_valid"], 0, (scratch["hist_ptr"] - n) % H)  # [B]
        entries = scratch["hist"][torch.arange(B, device=dev), idx]  # [B, A, 8]
        pos = torch.cumsum(rec.to(torch.int64), 0)  # 1-based rank among the recording envs
        total = pos[-1]
        keep = rec & (total - pos < cap)
        slots = torch.where(keep, (scratch["isb_size"] + pos - 1) % cap, cap)
        buf = scratch["isb_buffer"].clone()
        buf[slots] = entries
        scratch["isb_buffer"] = buf
        scratch["isb_size"] = scratch["isb_size"] + total
        return state.replace(scenario=scratch)

    # ------------------------------------------------------------------
    def _add_noise(self, obs, state, slot):
        if not self.is_add_noise:
            return obs
        gen = self.obs_generator(slot)
        return obs + self.noise_level * torch.rand(obs.shape, generator=gen, device=obs.device)

    def observations(self, state):
        """All egos' observations in one kernel launch when the
        configuration has the default observation structure; None makes
        the environment call ``observation`` per agent."""
        if not self.pallas_obs:
            return None
        if not (
            self.is_ego_view
            and self.is_partial_observation
            and self.is_observe_vertices
            and self.is_observe_distance_to_agents
            and self.is_observe_distance_to_boundaries
            and self.is_observe_distance_to_center_line
            and not self.is_observe_ref_path_other_agents
        ):
            return None
        obs = rtk.obs_all(*self.obs_inputs(state), **self.obs_kw)  # [A, B, W]
        return tuple(self._add_noise(obs[a.slot], state, a.slot) for a in self.world.policy_agents)

    def obs_inputs(self, state):
        """The observation kernel's tensor arguments, contiguous, in
        ``obs_all``'s order."""
        s = state.scenario
        pos, rot, vel = self._agent_arrays(state)
        return tuple(t.contiguous() for t in (
            pos, rot, vel, s["short_term"], s["verts"],
            s["d_ref"], s["d_left"].min(-1).values, s["d_right"].min(-1).values,
        ))

    def observation(self, agent, state):
        """One agent's observation, for every observation flag."""
        s = state.scenario
        i = agent.slot
        B = state.batch_dim
        A = self.n_agents
        pos, rot, vel = self._agent_arrays(state)
        pos_i, rot_i = pos[:, i], rot[:, i]

        def to_local(points):
            """points [B, ..., 2] -> ego frame of agent i (polar form)."""
            vec = points - pos_i.reshape((B,) + (1,) * (points.ndim - 2) + (2,))
            vec_abs = safe_norm(vec)
            rel = torch.atan2(vec[..., 1], vec[..., 0]) - rot_i.reshape((B,) + (1,) * (points.ndim - 2))
            return torch.stack([torch.cos(rel) * vec_abs, torch.sin(rel) * vec_abs], -1)

        norm_pos = self.norm_pos if self.is_ego_view else self.norm_pos_world

        if self.is_ego_view:
            pos_others = to_local(pos) / norm_pos  # [B, A, 2]
            rot_others = (rot - rot_i[:, None]) / self.norm_rot
            vel_abs = safe_norm(vel)
            rot_rel = rot - rot_i[:, None]
            vel_others = torch.stack([vel_abs * torch.cos(rot_rel), vel_abs * torch.sin(rot_rel)], -1) / self.norm_v
            ref_others = to_local(s["short_term"]) / norm_pos  # [B, A, S, 2]
            vert_others = to_local(s["verts"][:, :, 0:4]) / norm_pos  # [B, A, 4, 2]
        else:
            pos_others = pos / norm_pos
            rot_others = rot / self.norm_rot
            vel_others = vel / self.norm_v
            ref_others = s["short_term"] / norm_pos
            vert_others = s["verts"][:, :, 0:4] / norm_pos

        d_agents_n = s["d_agents"] / self.norm_distance_lanelet

        if self.is_partial_observation:
            # the K nearest by a masked minimum taken K times, ties to the
            # lowest index (the order of jax.lax.top_k)
            d_cur = s["d_agents"][:, i]
            iota = torch.arange(A, device=pos.device)
            near, picks = [], []
            for _ in range(self.n_nearing_agents):
                m = d_cur.min(-1).values
                idx_k = torch.where(d_cur == m[:, None], iota, A).min(-1).values
                d_cur = torch.where(iota == idx_k[:, None], torch.inf, d_cur)
                near.append(m)
                picks.append(idx_k)
            near_d, idx = torch.stack(near, -1), torch.stack(picks, -1)  # [B, K]
            mask_far = (
                near_d >= self.threshold_mask_agents if self.is_apply_mask
                else torch.zeros_like(near_d, dtype=torch.bool)
            )

            def take(arr):
                ix = idx.reshape((B, -1) + (1,) * (arr.ndim - 2)).expand((B, idx.shape[1]) + arr.shape[2:])
                return torch.gather(arr, 1, ix)

            obs_pos = torch.where(mask_far[..., None], 1.0, take(pos_others))
            obs_rot = torch.where(mask_far, 0.0, take(rot_others))
            obs_vel = torch.where(mask_far[..., None], 0.0, take(vel_others))
            obs_ref = torch.where(mask_far[..., None, None], 1.0, take(ref_others))
            obs_vert = torch.where(mask_far[..., None, None], 1.0, take(vert_others))
            obs_dist = torch.where(mask_far, 1.0, torch.gather(d_agents_n[:, i], 1, idx))
            n_obs = self.n_nearing_agents
        else:
            obs_pos, obs_rot, obs_vel = pos_others, rot_others, vel_others
            obs_ref, obs_vert = ref_others, vert_others
            obs_dist = d_agents_n[:, i].clone()
            obs_dist[:, i] = 0.0
            n_obs = A

        others = [
            obs_vert.reshape(B, n_obs, -1)
            if self.is_observe_vertices
            else torch.cat([obs_pos.reshape(B, n_obs, -1), obs_rot.reshape(B, n_obs, -1)], -1),
            obs_vel.reshape(B, n_obs, -1),
        ]
        if self.is_observe_distance_to_agents:
            others.append(obs_dist.reshape(B, n_obs, -1))
        if self.is_observe_ref_path_other_agents:
            others.append(obs_ref.reshape(B, n_obs, -1))
        obs_other_agents = torch.cat(others, -1).reshape(B, -1)

        obs_self = []
        if not self.is_ego_view:
            obs_self.append(pos_others[:, i].reshape(B, -1))
            obs_self.append(rot_others[:, i].reshape(B, -1))
            obs_self.append(vel_others[:, i].reshape(B, -1))
        else:
            # in the ego frame only the longitudinal component is informative
            obs_self.append(vel_others[:, i, 0:1].reshape(B, -1))
        obs_self.append(ref_others[:, i].reshape(B, -1))
        if self.is_observe_distance_to_center_line:
            obs_self.append((s["d_ref"][:, i] / self.norm_distance_lanelet).reshape(B, -1))
        if self.is_observe_distance_to_boundaries:
            obs_self.append((s["d_left"][:, i].min(-1).values / self.norm_distance_lanelet).reshape(B, -1))
            obs_self.append((s["d_right"][:, i].min(-1).values / self.norm_distance_lanelet).reshape(B, -1))
        else:
            lb = to_local(s["near_left_b"]) / norm_pos if self.is_ego_view else s["near_left_b"] / norm_pos
            rb = to_local(s["near_right_b"]) / norm_pos if self.is_ego_view else s["near_right_b"] / norm_pos
            obs_self.append(lb[:, i].reshape(B, -1))
            obs_self.append(rb[:, i].reshape(B, -1))

        obs = torch.cat(obs_self + [obs_other_agents], -1)
        return self._add_noise(obs, state, agent.slot)

    def done(self, state):
        s = state.scenario
        if self.is_testing_mode:
            return torch.zeros((state.batch_dim,), dtype=torch.bool, device=state.device)
        if self.map_type == "3":
            # the reward phase's flags, cached before the resets
            return s["done_flags"]
        is_coll_agents = s["coll_agents"].reshape(state.batch_dim, -1).any(-1)
        is_coll_lanelets = s["coll_lanelets"].any(-1)
        return is_coll_agents | is_coll_lanelets

    def info(self, agent, state):
        s = state.scenario
        i = agent.slot
        pos, rot, vel = self._agent_arrays(state)
        u = agent.u(state)
        return {
            "pos": pos[:, i] / self.norm_pos_world,
            "rot": angle_eliminate_two_pi(rot[:, i]) / self.norm_rot,
            "vel": vel[:, i] / self.norm_v,
            "act_vel": u[:, 0] / self.norm_action_vel,
            "act_steer": u[:, 1] / self.norm_action_steering,
            "ref": (s["short_term"][:, i] / self.norm_pos_world).reshape(state.batch_dim, -1),
            "distance_ref": s["d_ref"][:, i] / self.norm_distance_ref,
            "distance_left_b": s["d_left"][:, i].min(-1).values / self.norm_distance_lanelet,
            "distance_right_b": s["d_right"][:, i].min(-1).values / self.norm_distance_lanelet,
            "is_collision_with_agents": s["coll_agents"][:, i].any(-1),
            "is_collision_with_lanelets": s["coll_lanelets"].any(-1),
        }
