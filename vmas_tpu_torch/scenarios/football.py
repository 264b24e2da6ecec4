"""Football: a blue team against a red team, a ball, two goals and a
scripted team AI.

Counterpart of vmas_tpu/scenarios/football.py. The ball is a scripted agent
(``ball_action_script``: its anti-stall impulses near the walls); the team
AI (``AgentPolicy``) keeps each team's objectives and possession in scratch
as ``ai_Red`` / ``ai_Blue`` dicts of ``[B, A, ...]`` tensors, and evaluates
its Hermite trajectories through constant coefficient rows
(``hermite_coeffs``). The AI's random draws come from the step's seeded
streams (``BaseScenario.obs_generator``), each team and purpose on its own
salt.

Its outputs come out of the fused step as rows (``FootballOutputs``) for
the flat-observation configs without shooting: the score, the dense
shaping terms and every policy agent's observation, the red team's x rows
negated. In the rows form the ball's script runs inside the kernel
(``fused.BallScriptActRows``) and the red policy agents' mirrored actions
are a decode transform; the scripted red AI runs outside the kernel, so
that config steps through ``env.step`` / ``rollout_fn`` only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Box, Color, Landmark, Line, Sphere, TorchUtils, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import X, Y, safe_norm
from vmas_tpu_torch.dynamics import Holonomic, HolonomicWithRotation
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


def hermite_coeffs(u: float, deriv: int) -> np.ndarray:
    """Row vector c so that spline(u) = c[0]*p0 + c[1]*p1 + c[2]*v0 + c[3]*v1
    (the JAX package's own, computed the same way)."""
    A = np.array(
        [[2.0, -2.0, 1.0, 1.0], [-3.0, 3.0, -2.0, -1.0], [0.0, 0.0, 1.0, 0.0], [1.0, 0.0, 0.0, 0.0]]
    )

    def nPr(n, r):
        if r > n:
            return 0
        ans = 1
        for k in range(n, max(1, n - r), -1):
            ans *= k
        return ans

    U = np.array(
        [
            nPr(3, deriv) * (u ** max(0, 3 - deriv)),
            nPr(2, deriv) * (u ** max(0, 2 - deriv)),
            nPr(1, deriv) * (u ** max(0, 1 - deriv)),
            nPr(0, deriv),
        ],
        dtype=np.float32,
    )
    return U @ A


def _norm_dir(v):
    """Unit vector; zeros where the norm is zero."""
    n = safe_norm(v)[..., None]
    return torch.where(n == 0, 0.0, v / torch.where(n == 0, 1.0, n))


def _set_slot(arr, i, new, mask=None):
    """``arr`` with slot ``i`` of axis 1 set to ``new`` where ``mask`` ([B])
    holds (everywhere without one), out of place."""
    out = arr.clone()
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
        new = torch.where(m, new, arr[:, i])
    out[:, i] = new
    return out


# salts of the AI's draws (the JAX package's), and the red team's offset
_SALT_SAMPLES, _SALT_POSSESSION, _SALT_VALUE, _SALT_PRECISION = 500, 77, 88, 1000
_RED_OFFSET = 1_000_000


class AgentPolicy:
    """The football team AI, as the JAX package's AgentPolicy: possession,
    dribbling, repositioning to the best of sampled candidates, and the
    Hermite control. Its state lives in scenario scratch under ``ai_{team}``;
    the methods take and return that dict.

    Each env keeps its own best candidate (the JAX package's deliberate fix
    of the reference's env-0 gather). ``forced_objectives``: the
    repositioning targets are read from the scratch's ``forced_best_pos``
    instead (the replay harness of the recorded AI trajectories). The
    candidates' offsets are drawn once a step for the whole team by slot 0
    (``sample_offsets``) and written to the scratch (``cbp_samples``) before
    any agent reads them."""

    def __init__(self, scenario, team, speed_strength=1.0, decision_strength=1.0,
                 precision_strength=1.0, disabled=False, forced_objectives=False):
        self.scenario = scenario
        self.team_name = team
        self.speed_strength = speed_strength**2
        self.decision_strength = decision_strength
        self.precision_strength = precision_strength
        self.strength_multiplier = 25.0
        self.pos_lookahead = 0.01
        self.vel_lookahead = 0.01
        self.possession_lookahead = 0.5
        self.dribble_speed = 0.16 + 0.16 * speed_strength
        self.shooting_radius = 0.08
        self.shooting_angle = math.pi / 2
        self.take_shot_angle = math.pi / 4
        self.max_shot_dist = 0.5
        self.nsamples = 2
        self.sigma = 0.5
        self.replan_margin = 0.0
        self.disabled = disabled
        self.forced_objectives = forced_objectives
        self.key = f"ai_{team}"
        self.pos_coeffs = [float(c) for c in np.float32(hermite_coeffs(min(self.pos_lookahead, 1), 0))]
        self.vel_coeffs = [float(c) for c in np.float32(hermite_coeffs(min(self.vel_lookahead, 1), 1))]

    # -- wiring ----------------------------------------------------------
    @property
    def teammates(self):
        return self.scenario.red_agents if self.team_name == "Red" else self.scenario.blue_agents

    @property
    def opposition(self):
        return self.scenario.blue_agents if self.team_name == "Red" else self.scenario.red_agents

    @property
    def own_net(self):
        return self.scenario.red_net if self.team_name == "Red" else self.scenario.blue_net

    @property
    def target_net(self):
        return self.scenario.blue_net if self.team_name == "Red" else self.scenario.red_net

    def slot_in_team(self, agent):
        return self.teammates.index(agent)

    def init_scratch(self, B, device):
        A = len(self.teammates)
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        return {
            "shot_power": z(B, A),
            "target_ang": z(B, A),
            "target_pos_rel": z(B, A, 2),
            "target_pos": z(B, A, 2),
            "target_vel": z(B, A, 2),
            "start_pos": z(B, A, 2),
            "start_vel": z(B, A, 2),
            "agent_possession": torch.zeros((B, A), dtype=torch.bool, device=device),
            "team_possession": torch.zeros((B,), dtype=torch.bool, device=device),
            "forced_best_pos": z(B, A, 2),
            "cbp_samples": z(B, A, self.nsamples, 2),
        }

    # -- helpers ----------------------------------------------------------
    def _generator(self, salt):
        """The team's stream for ``salt`` this step: the step's seeded
        stream (``obs_generator``), teams apart by an offset."""
        return self.scenario.obs_generator((_RED_OFFSET if self.team_name == "Red" else 0) + salt)

    def sample_offsets(self, B, device):
        """The candidates' offsets of every agent of the team this step,
        [B, A, nsamples, 2]."""
        A = len(self.teammates)
        n = torch.randn((B, A, self.nsamples, 2), generator=self._generator(_SALT_SAMPLES), device=device)
        return n * self.sigma * (1 + 3 * (1 - self.decision_strength))

    def get_start_vel(self, pos, vel, start_pos, aggression):
        vel_mag = 1.0 * aggression + safe_norm(vel) * (1 - aggression)
        vel_dir = _norm_dir(vel)
        goal_dist = safe_norm(pos - start_pos)
        dist_behind_target = 0.6 * goal_dist
        target_pos = pos - vel_dir * dist_behind_target[:, None]
        start_vel_aug_dir = _norm_dir(target_pos - start_pos)
        return start_vel_aug_dir * vel_mag[:, None]

    def go_to(self, state, ai, agent, pos, vel=None, start_vel=None, aggression=1.0, mask=None):
        i = self.slot_in_team(agent)
        start_pos = agent.pos(state)
        if vel is None:
            vel = torch.zeros_like(pos)
        if start_vel is None:
            aggr = (safe_norm(pos - start_pos) > 0.1).to(torch.float32) * aggression
            start_vel = self.get_start_vel(pos, vel, start_pos, aggr)
        if self.precision_strength != 1:
            diff = safe_norm(ai["target_pos"][:, i] - pos)[:, None]
            exp_diff = torch.exp(-diff)
            gen = self._generator(_SALT_PRECISION + i)
            n_pos = torch.randn(pos.shape, generator=gen, device=pos.device)
            n_vel = torch.randn(pos.shape, generator=gen, device=pos.device)
            pos = pos + n_pos * 10 * (1 - self.precision_strength) * (1 - exp_diff)
            vel = vel + n_vel * 10 * (1 - self.precision_strength) * (1 - exp_diff)
        ball_pos = self.scenario.ball.pos(state)
        ai = dict(ai)
        ai["target_pos_rel"] = _set_slot(ai["target_pos_rel"], i, pos - ball_pos, mask)
        ai["target_pos"] = _set_slot(ai["target_pos"], i, pos, mask)
        ai["target_vel"] = _set_slot(ai["target_vel"], i, vel, mask)
        ai["start_pos"] = _set_slot(ai["start_pos"], i, start_pos, mask)
        ai["start_vel"] = _set_slot(ai["start_vel"], i, start_vel, mask)
        return ai

    def update_dribble(self, state, ai, agent, pos, mask):
        agent_pos = agent.pos(state)
        ball_pos = self.scenario.ball.pos(state)
        ball_disp = pos - ball_pos
        direction = _norm_dir(ball_disp)
        hit_vel = direction * self.dribble_speed
        start_vel = self.get_start_vel(ball_pos, hit_vel, agent_pos, aggression=0.0)
        offset = _norm_dir(start_vel)
        new_direction = _norm_dir(direction + 0.5 * offset)
        hit_pos = ball_pos - new_direction * (self.scenario.ball.shape.radius + agent.shape.radius) * 0.7
        return self.go_to(state, ai, agent, hit_pos, hit_vel, start_vel=start_vel, mask=mask)

    def get_rel_ang(self, vec1=None, vec2=None, ang1=None, ang2=None):
        if vec1 is not None:
            ang1 = torch.atan2(vec1[:, 1], vec1[:, 0])
        if vec2 is not None:
            ang2 = torch.atan2(vec2[:, 1], vec2[:, 0])
        if ang1.ndim == 2:
            ang1 = ang1[:, 0]
        if ang2.ndim == 2:
            ang2 = ang2[:, 0]
        return torch.remainder(ang1 - ang2 + math.pi, 2 * math.pi) - math.pi

    def dribble(self, state, ai, agent, pos, mask=None):
        return self.update_dribble(state, ai, agent, pos, mask=mask)

    def dribble_to_goal(self, state, ai, agent, mask=None):
        return self.dribble(state, ai, agent, self.target_net.pos(state), mask=mask)

    def shoot(self, state, ai, agent, pos, mask=None):
        """Line the agent up behind the ball facing ``pos`` and arm
        ``shot_power`` where the ball is within range and angle and the
        shot line within take_shot_angle; shot_power is re-armed from -1 for
        every env on each call, as in the JAX package."""
        i = self.slot_in_team(agent)
        agent_pos = agent.pos(state)
        ball_disp = self.scenario.ball.pos(state) - agent_pos
        ball_dist = safe_norm(ball_disp)
        within_range = ball_dist <= self.shooting_radius
        target_disp = pos - agent_pos
        target_dist = safe_norm(target_disp)
        rot = agent.rot(state)
        ball_within = torch.abs(self.get_rel_ang(ang1=rot, vec2=ball_disp)) < self.shooting_angle / 2
        rot_within = torch.abs(self.get_rel_ang(ang1=rot, vec2=target_disp)) < self.take_shot_angle / 2
        shooting_mask = within_range & ball_within & rot_within
        m = mask if mask is not None else torch.ones_like(shooting_mask)
        ai = dict(ai)
        target_ang = torch.atan2(target_disp[:, 1], target_disp[:, 0])
        ai["target_ang"] = _set_slot(ai["target_ang"], i, target_ang, m)
        ai = self.update_dribble(state, ai, agent, pos, mask=mask)
        sp = torch.full_like(ai["shot_power"][:, i], -1.0)
        sp = torch.where(shooting_mask & m, torch.clamp(F._div(target_dist, self.max_shot_dist), max=1.0), sp)
        ai["shot_power"] = _set_slot(ai["shot_power"], i, sp)
        return ai

    def dribble_policy(self, state, ai, agent):
        """The possession holder dribbles to the target net; everyone else
        repositions to the best candidate."""
        i = self.slot_in_team(agent)
        possession_mask = ai["agent_possession"][:, i]
        ai = self.update_dribble(state, ai, agent, self.target_net.pos(state), mask=possession_mask)
        best_pos = ai["forced_best_pos"][:, i] if self.forced_objectives else self.check_better_positions(
            state, ai, agent)
        return self.go_to(state, ai, agent, best_pos, aggression=1.0, mask=~possession_mask)

    def passing_policy(self, state, ai, agent):
        """The possession holder shoots toward a teammate instead (the
        alternative the reference ships; ``run`` uses ``dribble_policy``)."""
        i = self.slot_in_team(agent)
        possession_mask = ai["agent_possession"][:, i]
        otheragent = next(a for a in self.teammates if a is not agent)
        ai = self.shoot(state, ai, agent, otheragent.pos(state), mask=possession_mask)
        best_pos = ai["forced_best_pos"][:, i] if self.forced_objectives else self.check_better_positions(
            state, ai, agent)
        return self.go_to(state, ai, agent, best_pos, aggression=1.0, mask=~possession_mask)

    def disable(self):
        self.disabled = True

    def enable(self):
        self.disabled = False

    def check_possession(self, state, ai):
        """Team possession: the agent nearest the ball's look-ahead is a
        teammate; agent possession: the first teammate of least distance
        less half its side term."""
        team = self.teammates
        all_agents = team + self.opposition
        agents_pos = torch.stack([a.pos(state) for a in all_agents], dim=1)
        agents_vel = torch.stack([a.vel(state) for a in all_agents], dim=1)
        ball_pos = self.scenario.ball.pos(state)
        ball_vel = self.scenario.ball.vel(state)
        ball_disps = ball_pos[:, None, :] - agents_pos
        relvels = ball_vel[:, None, :] - agents_vel
        dists = safe_norm(ball_disps + relvels * self.possession_lookahead)
        ai = dict(ai)
        ai["team_possession"] = torch.argmin(dists, dim=-1) < len(team)
        net_disps = self.target_net.pos(state)[:, None, :] - agents_pos
        side_dot_prod = torch.sum(_norm_dir(ball_disps) * _norm_dir(net_disps), dim=-1)
        dists = dists - 0.5 * side_dot_prod * self.decision_strength
        if self.decision_strength != 1:
            n = torch.randn(dists.shape, generator=self._generator(_SALT_POSSESSION), device=dists.device)
            dists = dists + 0.5 * n * (1 - self.decision_strength) ** 2
        mindist_agents = torch.argmin(dists[:, : len(team)], dim=-1)
        ai["agent_possession"] = mindist_agents[:, None] == torch.arange(len(team), device=dists.device)[None]
        return ai

    def clamp_pos(self, pos):
        s = self.scenario
        agent_size = s.agent_size
        pitch_y = s.pitch_width / 2 - agent_size
        pitch_x = s.pitch_length / 2 - agent_size
        goal_y = s.goal_size / 2 - agent_size
        goal_x = s.goal_depth
        y = torch.clamp(pos[..., Y], -pitch_y, pitch_y)
        inside_goal_y = torch.abs(y) < goal_y
        x = torch.where(
            inside_goal_y,
            torch.clamp(pos[..., X], -pitch_x - goal_x, pitch_x + goal_x),
            torch.clamp(pos[..., X], -pitch_x, pitch_x),
        )
        return torch.stack([x, y], dim=-1)

    def get_pos_value(self, state, ai, pos, agent):
        """The value of candidate positions ``pos`` [B, S, 2] -> [B, S]."""
        s = self.scenario
        ball_pos = s.ball.pos(state)[:, None]
        target_net_pos = self.target_net.pos(state)[:, None]
        own_net_pos = self.own_net.pos(state)[:, None]
        ball_vec = _norm_dir(ball_pos - pos)

        ball_dist = safe_norm(pos - ball_pos)
        ball_dist_sq = ball_dist * ball_dist
        ball_dist_value = torch.exp(-2 * (ball_dist_sq * ball_dist_sq))

        net_vec = _norm_dir(target_net_pos - pos)
        side_dot_prod = torch.sum(ball_vec * net_vec, dim=-1)
        side_value = torch.clamp(side_dot_prod + 1.25, max=1.0)

        # the reference divides own_net_vec by the norm of the already
        # normalised net_vec, i.e. by 1: own_net_vec keeps its magnitude
        net_vec_norm = safe_norm(net_vec)[..., None]
        own_net_vec = (own_net_pos - pos) / torch.where(net_vec_norm == 0, 1.0, net_vec_norm)
        defend_dot_prod = torch.sum(ball_vec * -own_net_vec, dim=-1)
        defend_value = torch.clamp(defend_dot_prod, min=0.0)

        team = self.teammates
        if len(team) > 1:
            others = [a for a in team if a is not agent]
            team_pos = torch.stack([a.pos(state) for a in others], dim=1)  # [B, T-1, 2]
            team_dists = safe_norm(team_pos[:, None] - pos[:, :, None])  # [B, S, T-1]
            e = torch.exp(-5 * team_dists)
            other_agent_value = -torch.sqrt(torch.sum(e * e, dim=-1)) + 1
        else:
            other_agent_value = 0.0

        top = -pos[..., Y] + s.pitch_width / 2
        bottom = pos[..., Y] + s.pitch_width / 2
        left = pos[..., X] + s.pitch_length / 2
        right = -pos[..., X] + s.pitch_length / 2
        v_dist = torch.minimum(top, bottom)
        h_dist = torch.minimum(left, right)
        ev, eh = torch.exp(-8 * v_dist), torch.exp(-8 * h_dist)
        wall_value = -torch.sqrt(ev * ev + eh * eh) + 1

        value = F._div(wall_value + other_agent_value + ball_dist_value + side_value + defend_value, 5.0)
        if self.decision_strength != 1:
            n = torch.randn(value.shape, generator=self._generator(_SALT_VALUE), device=value.device)
            value = value + n * (1 - self.decision_strength)
        return value

    def check_better_positions(self, state, ai, agent):
        """The best of the agent's current target and its sampled
        candidates, per env; ties go to the first (a one-hot sum, one exact
        term)."""
        i = self.slot_in_team(agent)
        ball_pos = self.scenario.ball.pos(state)
        curr_target = ai["target_pos_rel"][:, i] + ball_pos
        samples = ai["cbp_samples"][:, i]
        agent_pos = agent.pos(state)
        means = torch.stack([ball_pos if j % 2 == 0 else agent_pos for j in range(self.nsamples)], dim=1)
        samples = samples + means
        test_pos = torch.cat([curr_target[:, None, :], samples], dim=1)
        test_pos = self.clamp_pos(test_pos)
        values = self.get_pos_value(state, ai, test_pos, agent)
        margin = np.zeros(self.nsamples + 1, np.float32)
        margin[0] = self.replan_margin + 3 * (1 - self.decision_strength)
        values = values + torch.as_tensor(margin, device=values.device)[None]
        best = torch.argmax(values, dim=1)
        sel = (best[:, None] == torch.arange(test_pos.shape[1], device=best.device)[None]).to(test_pos.dtype)
        return torch.sum(sel[..., None] * test_pos, dim=1)

    def get_action(self, state, ai, agent):
        """The Hermite control toward the agent's trajectory: the spline's
        position and velocity at the look-ahead, as the 4-term sums of the
        coefficient rows, in order."""
        i = self.slot_in_team(agent)
        P = [ai["start_pos"][:, i], ai["target_pos"][:, i], ai["start_vel"][:, i], ai["target_vel"][:, i]]
        cp, cv = self.pos_coeffs, self.vel_coeffs
        des_pos = cp[0] * P[0] + cp[1] * P[1] + cp[2] * P[2] + cp[3] * P[3]
        des_vel = cv[0] * P[0] + cv[1] * P[1] + cv[2] * P[2] + cv[3] * P[3]
        movement = 0.5 * (des_pos - agent.pos(state)) + 0.5 * (des_vel - agent.vel(state))
        movement = movement * (self.speed_strength * self.strength_multiplier)
        if agent.action_size == 2:
            return movement
        rel_ang = torch.remainder(ai["target_ang"][:, i] - agent.rot(state) + math.pi, 2 * math.pi) - math.pi
        rot_ctrl = torch.where(rel_ang > math.pi / 2, 1.0,
                               torch.where(rel_ang < -math.pi / 2, -1.0, torch.sin(rel_ang)))
        shooting = torch.stack([rot_ctrl, ai["shot_power"][:, i]], dim=-1)
        return torch.cat([movement, shooting], dim=-1)

    def run(self, agent, world, state):
        """The scripted agent's action script."""
        if self.disabled:
            return agent.set_u(state, torch.zeros((state.batch_dim, agent.action_size), device=state.device))
        scratch = dict(state.scenario)
        ai = dict(scratch[self.key])
        if self.slot_in_team(agent) == 0:
            ai = self.check_possession(state, ai)
            if not self.forced_objectives:
                ai["cbp_samples"] = self.sample_offsets(state.batch_dim, state.device)
        ai = self.dribble_policy(state, ai, agent)
        control = self.get_action(state, ai, agent)
        u_range = torch.as_tensor(agent.u_range_array, device=state.device)[None]
        control = torch.clamp(control, -u_range, u_range)
        u = control * torch.as_tensor(agent.u_multiplier_array, device=state.device)[None]
        scratch[self.key] = ai
        state = state.replace(scenario=scratch)
        return agent.set_u(state, u)


class Scenario(BaseScenario):
    def init_params(self, **kwargs):
        self.viewer_size = kwargs.pop("viewer_size", (1200, 800))
        self.n_blue_agents = kwargs.pop("n_blue_agents", 3)
        self.n_red_agents = kwargs.pop("n_red_agents", 3)
        self.ai_red_agents = kwargs.pop("ai_red_agents", True)
        self.ai_blue_agents = kwargs.pop("ai_blue_agents", False)
        self.physically_different = kwargs.pop("physically_different", False)
        self.spawn_in_formation = kwargs.pop("spawn_in_formation", False)
        self.only_blue_formation = kwargs.pop("only_blue_formation", True)
        self.formation_agents_per_column = kwargs.pop("formation_agents_per_column", 2)
        self.randomise_formation_indices = kwargs.pop("randomise_formation_indices", False)
        self.formation_noise = kwargs.pop("formation_noise", 0.2)
        self.n_traj_points = kwargs.pop("n_traj_points", 0)
        self.ai_speed_strength = kwargs.pop("ai_strength", 1.0)
        self.ai_decision_strength = kwargs.pop("ai_decision_strength", 1.0)
        self.ai_precision_strength = kwargs.pop("ai_precision_strength", 1.0)
        self.disable_ai_red = kwargs.pop("disable_ai_red", False)
        # a replay harness's hook: the scripted AIs read their repositioning
        # targets from scratch (``forced_best_pos``) instead of sampling them
        self.ai_forced_objectives = kwargs.pop("ai_forced_objectives", False)
        self.agent_size = kwargs.pop("agent_size", 0.025)
        self.goal_size = kwargs.pop("goal_size", 0.35)
        self.goal_depth = kwargs.pop("goal_depth", 0.1)
        self.pitch_length = kwargs.pop("pitch_length", 3.0)
        self.pitch_width = kwargs.pop("pitch_width", 1.5)
        self.ball_mass = kwargs.pop("ball_mass", 0.25)
        self.ball_size = kwargs.pop("ball_size", 0.02)
        self.u_multiplier = kwargs.pop("u_multiplier", 0.1)
        self.enable_shooting = kwargs.pop("enable_shooting", False)
        self.u_rot_multiplier = kwargs.pop("u_rot_multiplier", 0.0003)
        self.u_shoot_multiplier = kwargs.pop("u_shoot_multiplier", 0.6)
        self.shooting_radius = kwargs.pop("shooting_radius", 0.08)
        self.shooting_angle = kwargs.pop("shooting_angle", math.pi / 2)
        self.max_speed = kwargs.pop("max_speed", 0.15)
        self.ball_max_speed = kwargs.pop("ball_max_speed", 0.3)
        self.dense_reward = kwargs.pop("dense_reward", True)
        self.pos_shaping_factor_ball_goal = kwargs.pop("pos_shaping_factor_ball_goal", 10.0)
        self.pos_shaping_factor_agent_ball = kwargs.pop("pos_shaping_factor_agent_ball", 0.1)
        self.distance_to_ball_trigger = kwargs.pop("distance_to_ball_trigger", 0.4)
        self.scoring_reward = kwargs.pop("scoring_reward", 100.0)
        self.observe_teammates = kwargs.pop("observe_teammates", True)
        self.observe_adversaries = kwargs.pop("observe_adversaries", True)
        self.dict_obs = kwargs.pop("dict_obs", False)
        if kwargs.pop("dense_reward_ratio", None) is not None:
            raise ValueError("dense_reward_ratio in football is deprecated, please use `dense_reward`")
        ScenarioUtils.check_kwargs_consumed(kwargs)

    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.init_params(**kwargs)
        self.visualize_semidims = False
        world = World(
            batch_dim, device, dt=0.1, drag=0.05,
            x_semidim=self.pitch_length / 2 + self.goal_depth - self.agent_size,
            y_semidim=self.pitch_width / 2 - self.agent_size,
            substeps=2,
        )
        self._init_agents(world)
        self._init_ball(world)
        self._init_walls(world)
        self._init_goals(world)
        self.left_goal_pos = torch.tensor(
            [-self.pitch_length / 2 - self.ball_size / 2, 0.0], dtype=torch.float32, device=world.device
        )
        self.right_goal_pos = -self.left_goal_pos
        return world

    # -- construction -----------------------------------------------------
    def _agent_def(self, name, controller, shooting, u_mult_scale=0.0, shoot_scale=0.0, speed_delta=0.0,
                   radius_delta=0.0, rot_mult_delta=0.0):
        u_mult = self.u_multiplier + u_mult_scale
        return Agent(
            name=name,
            shape=Sphere(radius=self.agent_size + radius_delta),
            action_script=controller.run if controller is not None else None,
            u_multiplier=(
                [u_mult, u_mult] if not shooting
                else [u_mult, u_mult, self.u_rot_multiplier + rot_mult_delta, self.u_shoot_multiplier + shoot_scale]
            ),
            max_speed=self.max_speed + speed_delta,
            dynamics=Holonomic() if not shooting else HolonomicWithRotation(),
            action_size=2 if not shooting else 4,
            color=self.blue_color if name.startswith("agent_blue") else self.red_color,
            alpha=1,
        )

    def _init_agents(self, world):
        self.blue_color = (0.22, 0.49, 0.72)
        self.red_color = (0.89, 0.10, 0.11)
        self.blue_agents = []
        self.red_agents = []

        def strength(v, idx):
            return v[idx] if isinstance(v, tuple) else v

        self.red_controller = (
            AgentPolicy(
                self, "Red", disabled=self.disable_ai_red,
                speed_strength=strength(self.ai_speed_strength, 1),
                precision_strength=strength(self.ai_precision_strength, 1),
                decision_strength=strength(self.ai_decision_strength, 1),
                forced_objectives=self.ai_forced_objectives,
            )
            if self.ai_red_agents else None
        )
        self.blue_controller = (
            AgentPolicy(
                self, "Blue",
                speed_strength=strength(self.ai_speed_strength, 0),
                precision_strength=strength(self.ai_precision_strength, 0),
                decision_strength=strength(self.ai_decision_strength, 0),
                forced_objectives=self.ai_forced_objectives,
            )
            if self.ai_blue_agents else None
        )

        if self.physically_different:
            assert self.n_blue_agents == 5, "Physical differences only for 5 agents"
            # 2 attackers, 2 defenders, 1 goalkeeper
            defs = [
                dict(u_mult_scale=0.1, shoot_scale=-0.2, speed_delta=0.05, radius_delta=-0.005),
                dict(u_mult_scale=0.1, shoot_scale=-0.2, speed_delta=0.05, radius_delta=-0.005),
                dict(), dict(),
                dict(u_mult_scale=-0.05, speed_delta=-0.1, radius_delta=0.01, rot_mult_delta=0.2),
            ]
        else:
            defs = [dict() for _ in range(self.n_blue_agents)]
        for i, d in enumerate(defs):
            agent = self._agent_def(f"agent_blue_{i}", self.blue_controller, shooting=self.enable_shooting, **d)
            world.add_agent(agent)
            self.blue_agents.append(agent)
        for i in range(self.n_red_agents):
            agent = self._agent_def(f"agent_red_{i}", self.red_controller,
                                    shooting=self.enable_shooting and not self.ai_red_agents)
            world.add_agent(agent)
            self.red_agents.append(agent)

    def _init_ball(self, world):
        self.ball = Agent(
            name="Ball", shape=Sphere(radius=self.ball_size), action_script=self.ball_action_script,
            max_speed=self.ball_max_speed, mass=self.ball_mass, alpha=1, color=Color.BLACK,
        )
        world.add_agent(self.ball)
        # the ball's anti-stall impulses, shared by its action script and the
        # rows step's in-kernel script
        self.ball_script = F.BallScriptActRows(
            self.ball, dist_thres=self.agent_size * 2, vel_thres=0.3, impulse=0.05,
            pw_half=self.pitch_width / 2, pl_half=self.pitch_length / 2, y_goal=self.goal_size / 2,
        )

    def ball_action_script(self, ball, world, state):
        """The ball's anti-stall impulses (``fused.BallScriptActRows``): away
        from a wall it is near while its vertical speed is low, the x
        impulse off inside the goal mouth."""
        pos, vel = ball.pos(state), ball.vel(state)
        ax, ay = self.ball_script.impulse(pos[:, X], pos[:, Y], vel[:, Y])
        return ball.set_u(state, torch.stack([ax, ay], dim=1))

    def _init_walls(self, world):
        wall_len = self.pitch_width / 2 - self.agent_size - self.goal_size / 2
        self.walls = {}
        for name in ["Right Top Wall", "Left Top Wall", "Right Bottom Wall", "Left Bottom Wall"]:
            lm = Landmark(name=name, collide=True, movable=False, shape=Line(length=wall_len), color=Color.WHITE)
            world.add_landmark(lm)
            self.walls[name] = lm

    def _init_goals(self, world):
        self.goal_parts = {}
        for name, length in [
            ("Right Goal Back", self.goal_size), ("Left Goal Back", self.goal_size),
            ("Right Goal Top", self.goal_depth), ("Left Goal Top", self.goal_depth),
            ("Right Goal Bottom", self.goal_depth), ("Left Goal Bottom", self.goal_depth),
        ]:
            lm = Landmark(name=name, collide=True, movable=False, shape=Line(length=length), color=Color.WHITE)
            world.add_landmark(lm)
            self.goal_parts[name] = lm
        self.blue_net = Landmark(name="Blue Net", collide=False, movable=False,
                                 shape=Box(length=self.goal_depth, width=self.goal_size), color=(0.5, 0.5, 0.5))
        world.add_landmark(self.blue_net)
        self.red_net = Landmark(name="Red Net", collide=False, movable=False,
                                shape=Box(length=self.goal_depth, width=self.goal_size), color=(0.5, 0.5, 0.5))
        world.add_landmark(self.red_net)

    # -- reset -------------------------------------------------------------
    def formation_slots(self, n, blue):
        """The formation's positions of ``n`` agents, [n, 2] (float64)."""
        positions = []
        endpoint = -(self.pitch_length / 2 + self.goal_depth) * (1 if blue else -1)
        n_cols = n // self.formation_agents_per_column + 3
        agent_index = 0
        for x in np.linspace(0, endpoint, n_cols):
            if agent_index >= n:
                break
            if x == 0 or x == endpoint:
                continue
            n_this = len(range(agent_index, min(n, agent_index + self.formation_agents_per_column)))
            for y in np.linspace(self.pitch_width / 2, -self.pitch_width / 2, n_this + 2):
                if y == -self.pitch_width / 2 or y == self.pitch_width / 2:
                    continue
                positions.append((x, y))
                agent_index += 1
        return np.asarray(positions)

    def _spawn_formation(self, state, agents, blue, generator):
        """Each agent at its formation slot plus uniform noise; with
        ``randomise_formation_indices`` the slots are permuted per env."""
        B, dev = state.batch_dim, state.device
        pos_arr = torch.as_tensor(self.formation_slots(len(agents), blue), dtype=torch.float32, device=dev)
        if self.randomise_formation_indices:
            # [B, n]: a uniform random permutation per env
            perm = torch.argsort(torch.rand((B, len(agents)), generator=generator, device=dev), dim=1)
        for i, agent in enumerate(agents):
            noise = (torch.rand((B, 2), generator=generator, device=dev) - 0.5) * self.formation_noise
            base = pos_arr[perm[:, i]] if self.randomise_formation_indices else pos_arr[i]
            state = agent.set_pos(state, base + noise)
        return state

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        reset_range = f32([self.pitch_length / 2, self.pitch_width])
        offset_blue = f32([-self.pitch_length / 2 + self.agent_size, -self.pitch_width / 2])
        offset_red = f32([-self.agent_size, -self.pitch_width / 2])

        if self.spawn_in_formation:
            state = self._spawn_formation(state, self.blue_agents, True, generator)
            if not self.only_blue_formation:
                state = self._spawn_formation(state, self.red_agents, False, generator)
        else:
            for agent in self.blue_agents:
                r = torch.rand((B, 2), generator=generator, device=dev)
                state = agent.set_pos(state, r * reset_range + offset_blue)
        if (self.spawn_in_formation and self.only_blue_formation) or not self.spawn_in_formation:
            for agent in self.red_agents:
                r = torch.rand((B, 2), generator=generator, device=dev)
                state = agent.set_pos(state, r * reset_range + offset_red)
                state = agent.set_rot(state, torch.full((B,), math.pi, device=dev))

        # walls and goals
        pw4 = self.pitch_width / 4 + self.goal_size / 4
        half_pi = math.pi / 2
        wall_defs = {
            "Left Top Wall": ([-self.pitch_length / 2, pw4], half_pi),
            "Left Bottom Wall": ([-self.pitch_length / 2, -pw4], half_pi),
            "Right Top Wall": ([self.pitch_length / 2, pw4], half_pi),
            "Right Bottom Wall": ([self.pitch_length / 2, -pw4], half_pi),
        }
        for name, (pos, rot) in wall_defs.items():
            state = self.walls[name].set_pos(state, f32(pos))
            state = self.walls[name].set_rot(state, f32(rot))
        gl = self.pitch_length / 2
        gd, gs, asz = self.goal_depth, self.goal_size, self.agent_size
        goal_defs = {
            "Left Goal Back": ([-gl - gd + asz, 0.0], half_pi),
            "Right Goal Back": ([gl + gd - asz, 0.0], half_pi),
            "Left Goal Top": ([-gl - gd / 2 + asz, gs / 2], 0.0),
            "Left Goal Bottom": ([-gl - gd / 2 + asz, -gs / 2], 0.0),
            "Right Goal Top": ([gl + gd / 2 - asz, gs / 2], 0.0),
            "Right Goal Bottom": ([gl + gd / 2 - asz, -gs / 2], 0.0),
        }
        for name, (pos, rot) in goal_defs.items():
            state = self.goal_parts[name].set_pos(state, f32(pos))
            state = self.goal_parts[name].set_rot(state, f32(rot))
        state = self.red_net.set_pos(state, f32([gl + gd / 2 - asz / 2, 0.0]))
        state = self.blue_net.set_pos(state, f32([-gl - gd / 2 + asz / 2, 0.0]))

        # the shaping baselines and the AI scratch
        scratch = dict(state.scenario)
        ball_pos = self.ball.pos(state)
        min_blue = self._closest_agent_to_ball(state, self.blue_agents)
        min_red = self._closest_agent_to_ball(state, self.red_agents)
        zero = lambda: torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch["min_agent_dist_to_ball_blue"] = min_blue
        scratch["min_agent_dist_to_ball_red"] = min_red
        scratch["pos_shaping_blue"] = safe_norm(ball_pos - self.right_goal_pos) * self.pos_shaping_factor_ball_goal
        scratch["pos_shaping_agent_blue"] = min_blue * self.pos_shaping_factor_agent_ball
        scratch["pos_shaping_red"] = safe_norm(ball_pos - self.left_goal_pos) * self.pos_shaping_factor_ball_goal
        scratch["pos_shaping_agent_red"] = min_red * self.pos_shaping_factor_agent_ball
        scratch["done"] = torch.zeros((B,), dtype=torch.bool, device=dev)
        for key in ("sparse_blue", "dense_blue", "dense_red", "pos_rew_blue", "pos_rew_red", "pos_rew_agent_blue",
                    "pos_rew_agent_red"):
            scratch[key] = zero()
        if self.enable_shooting:
            scratch["kicking_action"] = torch.zeros((B, 2), dtype=torch.float32, device=dev)
        for controller in (self.red_controller, self.blue_controller):
            if controller is not None:
                scratch[controller.key] = controller.init_scratch(B, dev)
        return state.replace(scenario=scratch)

    def _closest_agent_to_ball(self, state, team):
        pos = torch.stack([a.pos(state) for a in team], dim=1)
        return torch.min(safe_norm(pos - self.ball.pos(state)[:, None]), dim=1).values

    # -- actions ------------------------------------------------------------
    def process_action(self, agent, state):
        """A red policy agent acts in its mirrored frame (its u's x, and its
        rotation under shooting, negated); under shooting each policy agent
        kicks the ball where it is the closest agent, within range and
        within its shooting angle (the kick gathers in ``kicking_action``)."""
        if agent is self.ball:
            return state
        blue = agent in self.blue_agents
        if agent.action_script is None and not blue:
            u = agent.u(state).clone()
            u[:, X] = -u[:, X]
            if self.enable_shooting:
                u[:, 2] = -u[:, 2]
            state = agent.set_u(state, u)
        if self.enable_shooting and agent.action_script is None:
            agents_exclude_ball = [a for a in self.world.agents if a is not self.ball]
            rel = torch.stack([self.ball.pos(state) - a.pos(state) for a in agents_exclude_ball], dim=1)
            dist = safe_norm(rel)
            closest = dist == torch.min(dist, dim=-1, keepdim=True).values
            i = agents_exclude_ball.index(agent)
            rel_i = rel[:, i]
            within_range = dist[:, i] <= self.shooting_radius
            rel_angle = torch.remainder(
                agent.rot(state) - torch.atan2(rel_i[:, Y], rel_i[:, X]) + math.pi, 2 * math.pi
            ) - math.pi
            within_angle = (-self.shooting_angle / 2 <= rel_angle) & (rel_angle <= self.shooting_angle / 2)
            u = agent.u(state)
            shoot_force_local = torch.stack([u[:, -1] + self.u_shoot_multiplier, torch.zeros_like(u[:, -1])], dim=-1)
            shoot_force = TorchUtils.rotate_vector(shoot_force_local, agent.rot(state))
            shoot_force = torch.where((within_angle & within_range & closest[:, i])[:, None], shoot_force, 0.0)
            scratch = dict(state.scenario)
            scratch["kicking_action"] = scratch["kicking_action"] + shoot_force
            state = state.replace(scenario=scratch)
        return state

    def pre_step(self, state):
        if self.enable_shooting:
            scratch = dict(state.scenario)
            kick = scratch["kicking_action"]
            state = self.ball.set_u(state, self.ball.u(state) + kick)
            # the ball's dynamics again, so that the kick reaches its force
            state = self.ball.dynamics.process_action(self.world, state)
            scratch["kicking_action"] = torch.zeros_like(kick)
            state = state.replace(scenario=scratch)
        return state

    # -- rewards ------------------------------------------------------------
    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        ball_pos = self.ball.pos(state)
        over_right = ball_pos[:, X] > self.pitch_length / 2 + self.ball_size / 2
        over_left = ball_pos[:, X] < -self.pitch_length / 2 - self.ball_size / 2
        goal_mask = (ball_pos[:, Y] <= self.goal_size / 2) & (ball_pos[:, Y] >= -self.goal_size / 2)
        blue_score = over_right & goal_mask
        red_score = over_left & goal_mask
        scratch["sparse_blue"] = (self.scoring_reward * blue_score.to(torch.float32)
                                  - self.scoring_reward * red_score.to(torch.float32))
        scratch["done"] = blue_score | red_score

        dense_blue = torch.zeros_like(scratch["sparse_blue"])
        dense_red = torch.zeros_like(dense_blue)
        if self.dense_reward:
            if not self.ai_blue_agents:
                dense_blue, scratch = self._dense_reward(state, scratch, blue=True)
            if not self.ai_red_agents:
                dense_red, scratch = self._dense_reward(state, scratch, blue=False)
        scratch["dense_blue"] = dense_blue
        scratch["dense_red"] = dense_red
        return state.replace(scenario=scratch)

    def _dense_reward(self, state, scratch, blue):
        tag = "blue" if blue else "red"
        goal_pos = self.right_goal_pos if blue else self.left_goal_pos
        ball_pos = self.ball.pos(state)
        dist_goal = safe_norm(ball_pos - goal_pos)
        pos_shaping = dist_goal * self.pos_shaping_factor_ball_goal
        pos_rew = scratch[f"pos_shaping_{tag}"] - pos_shaping
        scratch[f"pos_shaping_{tag}"] = pos_shaping
        scratch[f"pos_rew_{tag}"] = pos_rew

        min_dist = self._closest_agent_to_ball(state, self.blue_agents if blue else self.red_agents)
        scratch[f"min_agent_dist_to_ball_{tag}"] = min_dist
        agent_shaping = min_dist * self.pos_shaping_factor_agent_ball
        ball_moving = safe_norm(self.ball.vel(state)) > 1e-6
        close = min_dist < self.distance_to_ball_trigger
        pos_rew_agent = torch.where(close | ball_moving, 0.0, scratch[f"pos_shaping_agent_{tag}"] - agent_shaping)
        scratch[f"pos_shaping_agent_{tag}"] = agent_shaping
        scratch[f"pos_rew_agent_{tag}"] = pos_rew_agent
        return pos_rew + pos_rew_agent, scratch

    def reward(self, agent, state):
        s = state.scenario
        if agent in self.blue_agents:
            return s["sparse_blue"] + s["dense_blue"]
        return -s["sparse_blue"] + s["dense_red"]

    # -- observations ---------------------------------------------------------
    def observation(self, agent, state):
        blue = agent in self.blue_agents
        my_team, other_team = (self.blue_agents, self.red_agents) if blue else (self.red_agents, self.blue_agents)
        goal_pos = self.right_goal_pos if blue else self.left_goal_pos
        B = state.batch_dim

        def flip(x):
            if blue:
                return x
            x = x.clone()
            x[..., X] = -x[..., X]
            return x

        agent_pos = flip(agent.pos(state))
        agent_vel = flip(agent.vel(state))
        agent_force = flip(agent.force(state))
        agent_rot = agent.rot(state) - (math.pi if not blue else 0.0)
        ball_pos = flip(self.ball.pos(state))
        ball_vel = flip(self.ball.vel(state))
        ball_force = flip(self.ball.force(state))
        goal_pos_f = flip(goal_pos).expand(B, 2)

        obs = {
            "obs": [agent_force, agent_pos - ball_pos, agent_vel - ball_vel, ball_pos - goal_pos_f, ball_vel,
                    ball_force],
            "pos": [agent_pos - goal_pos_f],
            "vel": [agent_vel],
        }
        if self.enable_shooting:
            obs["obs"].append(agent_rot[:, None])

        def rel(a):
            a_pos, a_vel, a_force = flip(a.pos(state)), flip(a.vel(state)), flip(a.force(state))
            return torch.cat([agent_pos - a_pos, agent_vel - a_vel, a_vel, a_force], dim=-1)

        if self.observe_adversaries and len(other_team):
            advs = [rel(a) for a in other_team]
            obs["adversaries"] = [torch.stack(advs, dim=-2) if self.dict_obs else torch.cat(advs, dim=-1)]
        if self.observe_teammates:
            mates = [rel(a) for a in my_team if a is not agent]
            obs["teammates"] = [torch.stack(mates, dim=-2) if self.dict_obs else torch.cat(mates, dim=-1)]

        out = {k: torch.cat(v, dim=-1) for k, v in obs.items()}
        if self.dict_obs:
            return out
        return torch.cat(list(out.values()), dim=-1)

    def done(self, state):
        return state.scenario["done"]

    def info(self, agent, state):
        s = state.scenario
        blue = agent in self.blue_agents
        tag = "blue" if blue else "red"
        return {
            "sparse_reward": s["sparse_blue"] if blue else -s["sparse_blue"],
            "ball_goal_pos_rew": s[f"pos_rew_{tag}"],
            "all_agent_ball_pos_rew": s[f"pos_rew_agent_{tag}"],
            "ball_pos": self.ball.pos(state),
            "dist_ball_to_goal": s[f"pos_shaping_{tag}"] / self.pos_shaping_factor_ball_goal,
            "min_agent_dist_to_ball": s[f"min_agent_dist_to_ball_{tag}"],
            "touching_ball": s[f"min_agent_dist_to_ball_{tag}"] <= self.agent_size + self.ball_size + 1e-2,
        }

    # -- fused outputs --------------------------------------------------------
    def make_fused_outputs(self, world):
        """The flat-observation configs without shooting emit their
        observations, rewards and done as rows of the fused step; the others
        run the hook pipeline (None)."""
        if self.dict_obs or self.enable_shooting or not world.policy_agents:
            return None
        return FootballOutputs(self, world)

    def extra_render(self, env, ax, env_index: int = 0):
        """The field, the blue agents' indices and the shooting sectors."""
        from vmas_tpu_torch.render import draw

        state = env.state
        half_l = self.pitch_length / 2
        half_w = self.pitch_width / 2
        if getattr(self, "_render_field", True):
            draw.draw_rect(ax, (0, 0), self.pitch_length, self.pitch_width, 0.0, Color.GREEN, zorder=0)
            draw.draw_circle(ax, (0, 0), self.goal_size / 2, Color.WHITE, filled=True, zorder=0)
            draw.draw_circle(ax, (0, 0), self.goal_size / 2 - 0.02, Color.GREEN, filled=True, zorder=0)
        # white pitch lines (centre, left and right verticals; top and bottom)
        vlen = half_w - self.agent_size
        for x in (0.0, half_l - self.agent_size, -half_l + self.agent_size):
            draw.draw_line(ax, (x, -vlen), (x, vlen), Color.WHITE, zorder=1)
        hlen = half_l - self.agent_size
        for y in (half_w - self.agent_size, -half_w + self.agent_size):
            draw.draw_line(ax, (-hlen, y), (hlen, y), Color.WHITE, zorder=1)

        draw.draw_agent_indices(ax, env, state, env_index, start_from=1, exclude=self.red_agents + [self.ball])

        if self.enable_shooting:
            pos = state.pos[env_index].numpy()
            rot = state.rot[env_index].numpy().reshape(-1)
            ball_p = pos[self.ball.index]
            for agent in self.blue_agents:
                p, r = pos[agent.index], rot[agent.index]
                rel = ball_p - p
                within_range = np.linalg.norm(rel) <= self.shooting_radius
                rel_angle = (r - np.arctan2(rel[1], rel[0]) + np.pi) % (2 * np.pi) - np.pi
                within_angle = abs(rel_angle) <= self.shooting_angle / 2
                color = Color.PINK if (within_range and within_angle) else agent.color
                draw.draw_wedge(ax, p, self.shooting_radius, r - self.shooting_angle / 2,
                                r + self.shooting_angle / 2, color, alpha=0.3, zorder=2)

    def top_layer_render(self, env, ax, env_index: int = 0):
        """The scripted teams' trajectory points: the hermite-spline knots of
        each AI agent's current objective, ``n_traj_points`` per agent, from
        the AI's scratch."""
        if self.n_traj_points <= 0:
            return
        from vmas_tpu_torch.render import draw

        scratch = env.state.scenario
        for controller, team in ((self.red_controller, self.red_agents), (self.blue_controller, self.blue_agents)):
            if controller is None or controller.key not in scratch:
                continue
            ai = scratch[controller.key]
            for i in range(len(team)):
                p0 = ai["start_pos"][env_index, i].numpy()
                p1 = ai["target_pos"][env_index, i].numpy()
                v0 = ai["start_vel"][env_index, i].numpy()
                v1 = ai["target_vel"][env_index, i].numpy()
                ctrl = np.stack([p0, p1, v0, v1])  # [4, 2]
                for u in np.linspace(0.0, 1.0, self.n_traj_points):
                    pt = hermite_coeffs(float(u), 0) @ ctrl
                    draw.draw_circle(ax, pt, 0.01, (0.5, 0.5, 0.5), filled=True, zorder=6)


class FootballOutputs(F.FusedOutputs):
    """Football's score, dense shaping and observations as extra rows of the
    fused step. ``emit`` is the plain version of the kernel's FootballEmit,
    row for row and in the JAX package's order of operations.

    Rows: per policy agent its observation (56 at the defaults: its force,
    pos - ball, vel - ball vel, ball - goal, ball vel, ball force, pos -
    goal, vel, then 8 per adversary and per teammate), the red team's x rows
    negated; then sparse_blue, dense_blue, dense_red and done; then per
    dense team (blue, then red, each where its agents are policies) 5 rows:
    pos_rew, pos_rew_agent, the new ball-to-goal and agent shapings, and the
    closest agent's distance to the ball. Scratch in: the previous two
    shapings per dense team, each carried from its emit row.

    The rows form runs the ball's script in the kernel
    (``process_act_rows``, ``fused.BallScriptActRows``): its 2 rows follow
    the emit rows and are the ball's u (``kernel_script_u``). Red policy
    agents' mirrored actions are a ``decode_transform``. ``pre_step`` acts
    only under shooting (``pre_step_noop``), and ``rollout()`` keeps
    ``rollout_fn`` (``rows_auto = False``, the JAX package's choice)."""

    pre_step_noop = True
    rows_auto = False
    n_ctrl_out = 2

    def __init__(self, scenario, world):
        sc = scenario
        agents = world.policy_agents
        blue_set = set(id(a) for a in sc.blue_agents)
        self.agent_i = [a.index for a in agents]
        self.is_blue = [id(a) in blue_set for a in agents]
        self.blue_i = [a.index for a in sc.blue_agents]
        self.red_i = [a.index for a in sc.red_agents]
        self.ball = sc.ball.index
        self.gx = float(sc.pitch_length / 2 + sc.ball_size / 2)
        self.x_over = float(sc.pitch_length / 2 + sc.ball_size / 2)
        self.y_goal = float(sc.goal_size / 2)
        self.scoring = float(sc.scoring_reward)
        self.f_goal = float(sc.pos_shaping_factor_ball_goal)
        self.f_agent = float(sc.pos_shaping_factor_agent_ball)
        self.trigger = float(sc.distance_to_ball_trigger)
        self.dense_blue = bool(sc.dense_reward and not sc.ai_blue_agents)
        self.dense_red = bool(sc.dense_reward and not sc.ai_red_agents)
        self.obs_adv = bool(sc.observe_adversaries)
        self.obs_team = bool(sc.observe_teammates)
        self.widths = [self._obs_w(b) for b in self.is_blue]
        n_dense = int(self.dense_blue) + int(self.dense_red)
        self.base = sum(self.widths)
        self.n_out = total = self.base + 4 + 5 * n_dense
        self.n_scratch_in = 2 * n_dense
        carry, o = [], self.base + 4
        for on in (self.dense_blue, self.dense_red):
            if on:
                carry += [o + 2, o + 3]
                o += 5
        self.carry_extra_idx = tuple(carry)
        self.kernel_script_slots = (self.ball,)
        self.kernel_script_u = ((self.ball, total, total + 1),)
        self.process_act_rows = sc.ball_script
        self.red_pos = [i for i, b in enumerate(self.is_blue) if not b]
        self._kernel_emit = None

    def _obs_w(self, blue):
        other = self.red_i if blue else self.blue_i
        team = self.blue_i if blue else self.red_i
        w = 12 + 2 + 2
        if self.obs_adv and len(other):
            w += 8 * len(other)
        if self.obs_team:
            w += 8 * (len(team) - 1)
        return w

    def decode_transform(self, us):
        """The red policy agents' decoded actions in their mirrored frame:
        x negated, as ``process_action`` negates it (the identity where
        every policy agent is blue)."""
        us = list(us)
        for i in self.red_pos:
            u = us[i].clone()
            u[..., 0] = -u[..., 0]
            us[i] = u
        return us

    def scratch_rows(self, state):
        s = state.scenario
        rows = []
        if self.dense_blue:
            rows += [s["pos_shaping_blue"], s["pos_shaping_agent_blue"]]
        if self.dense_red:
            rows += [s["pos_shaping_red"], s["pos_shaping_agent_red"]]
        if not rows:
            return torch.zeros((0, state.batch_dim), dtype=torch.float32, device=state.device)
        return torch.stack(rows, dim=0)

    def emit(self, ctx):
        px, py, vx, vy = ctx["px"], ctx["py"], ctx["vx"], ctx["vy"]
        fx, fy = ctx["fx"], ctx["fy"]
        prev = ctx["scratch"]
        bi = self.ball
        bpx, bpy = px[bi], py[bi]
        bvx, bvy = vx[bi], vy[bi]

        # the sparse block: over the line by ball_size / 2, within the mouth
        over_right = bpx > self.x_over
        over_left = bpx < -self.x_over
        goal_mask = (bpy <= self.y_goal) & (bpy >= -self.y_goal)
        blue_score = over_right & goal_mask
        red_score = over_left & goal_mask
        sparse_blue = self.scoring * blue_score.to(torch.float32) - self.scoring * red_score.to(torch.float32)
        done = (blue_score | red_score).to(torch.float32)

        def dense(team_idx, goal_sign, prev0, prev1):
            dist_goal = F._norm(bpx - goal_sign * self.gx, bpy)
            pos_shaping = dist_goal * self.f_goal
            pos_rew = prev0 - pos_shaping
            min_dist = None
            for ai in team_idx:
                d = F._norm(px[ai] - bpx, py[ai] - bpy)
                min_dist = d if min_dist is None else torch.minimum(min_dist, d)
            agent_shaping = min_dist * self.f_agent
            ball_moving = F._norm(bvx, bvy) > 1e-6
            close = min_dist < self.trigger
            pos_rew_agent = torch.where(close | ball_moving, 0.0, prev1 - agent_shaping)
            return pos_rew + pos_rew_agent, [pos_rew, pos_rew_agent, pos_shaping, agent_shaping, min_dist]

        k = 0
        dense_rows = []
        zero = torch.zeros_like(sparse_blue)
        dense_blue = dense_red = zero
        if self.dense_blue:
            dense_blue, extra = dense(self.blue_i, 1.0, prev[k], prev[k + 1])
            k += 2
            dense_rows += extra
        if self.dense_red:
            dense_red, extra = dense(self.red_i, -1.0, prev[k], prev[k + 1])
            k += 2
            dense_rows += extra

        rows = []
        for ai, blue in zip(self.agent_i, self.is_blue):
            sx = (lambda r: r) if blue else (lambda r: -r)
            other = self.red_i if blue else self.blue_i
            team = self.blue_i if blue else self.red_i
            gx = self.gx
            rows += [sx(fx[ai]), fy[ai]]
            rows += [sx(px[ai] - bpx), py[ai] - bpy]
            rows += [sx(vx[ai] - bvx), vy[ai] - bvy]
            rows += [sx(bpx) - gx, bpy]
            rows += [sx(bvx), bvy]
            rows += [sx(fx[bi]), fy[bi]]
            rows += [sx(px[ai]) - gx, py[ai]]
            rows += [sx(vx[ai]), vy[ai]]
            mates = [oi for oi in team if oi != ai] if self.obs_team else []
            for oi in (other if self.obs_adv else []) + mates:
                rows += [sx(px[ai] - px[oi]), py[ai] - py[oi], sx(vx[ai] - vx[oi]), vy[ai] - vy[oi],
                         sx(vx[oi]), vy[oi], sx(fx[oi]), fy[oi]]
        return rows + [sparse_blue, dense_blue, dense_red, done] + dense_rows

    def unpack(self, extra, state):
        """Output rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); leading axes pass through."""
        row = lambda r: extra[..., r, :]
        obs, o = [], 0
        for w in self.widths:
            obs.append(extra[..., o:o + w, :].transpose(-1, -2))
            o += w
        sparse, dense_b, dense_r = row(o), row(o + 1), row(o + 2)
        done = row(o + 3) > 0.5
        o += 4
        rews = tuple((sparse + dense_b) if blue else (-sparse + dense_r) for blue in self.is_blue)
        updates = {"sparse_blue": sparse, "dense_blue": dense_b, "dense_red": dense_r, "done": done}
        for on, tag in ((self.dense_blue, "blue"), (self.dense_red, "red")):
            if not on:
                continue
            updates[f"pos_rew_{tag}"] = row(o)
            updates[f"pos_rew_agent_{tag}"] = row(o + 1)
            updates[f"pos_shaping_{tag}"] = row(o + 2)
            updates[f"pos_shaping_agent_{tag}"] = row(o + 3)
            updates[f"min_agent_dist_to_ball_{tag}"] = row(o + 4)
            o += 5
        return tuple(obs), rews, done, updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if (max(len(self.agent_i), len(self.blue_i), len(self.red_i)) > K.MAX_A
                    or self.n_scratch_in > K.MAX_K):
                raise NotImplementedError(f"the fused kernel's football emit takes at most {K.MAX_A} agents a team")
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = ei
            p = ep.football
            p.n_agents, p.n_blue, p.n_red, p.ball = len(self.agent_i), len(self.blue_i), len(self.red_i), self.ball
            for i, (e, b) in enumerate(zip(self.agent_i, self.is_blue)):
                p.agent[i], p.blue[i] = e, b
            for i, e in enumerate(self.blue_i):
                p.blue_i[i] = e
            for i, e in enumerate(self.red_i):
                p.red_i[i] = e
            p.gx, p.x_over, p.y_goal, p.scoring = self.gx, self.x_over, self.y_goal, self.scoring
            p.f_goal, p.f_agent, p.trigger = self.f_goal, self.f_agent, self.trigger
            p.dense_blue, p.dense_red, p.obs_adv, p.obs_team = (self.dense_blue, self.dense_red, self.obs_adv,
                                                                self.obs_team)
            self._kernel_emit = (K.EMIT_FOOTBALL, ep)
        return self._kernel_emit
