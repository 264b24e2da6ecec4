"""Wheel: N agents spin a heavy line about a fixed pivot toward a desired
angular speed.

Counterpart of vmas_tpu/scenarios/wheel.py. Its world drives line-sphere
contacts of the agents on the rotating line and sphere-sphere contacts
among the agents; its outputs come out of the fused step as rows
(``WheelOutputs``). ``HeuristicPolicy`` is the JAX package's scripted
policy.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, Line, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import TorchUtils
from vmas_tpu_torch.scenario import BaseHeuristicPolicy, BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 4)
        self.line_length = kwargs.pop("line_length", 2)
        line_mass = kwargs.pop("line_mass", 30)
        self.desired_velocity = kwargs.pop("desired_velocity", 0.05)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device)
        for i in range(n_agents):
            world.add_agent(Agent(name=f"agent_{i}", u_multiplier=0.6, shape=Sphere(0.03)))
        self.line = Landmark(
            name="line", collide=True, rotatable=True, shape=Line(length=self.line_length), mass=line_mass,
            color=Color.BLACK,
        )
        world.add_landmark(self.line)
        world.add_landmark(Landmark(name="center", shape=Sphere(radius=0.02), collide=False, color=Color.BLACK))
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        for agent in self.world.agents:
            state = agent.set_pos(state, torch.rand((B, 2), generator=generator, device=dev) * 2 - 1)
        rot = (torch.rand((B,), generator=generator, device=dev) * 2 - 1) * (math.pi / 2)
        state = self.line.set_rot(state, rot)
        scratch = dict(state.scenario)
        scratch["rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        scratch["rew"] = torch.abs(torch.abs(self.line.ang_vel(state)) - self.desired_velocity)
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return -state.scenario["rew"]

    def observation(self, agent, state):
        rot = self.line.rot(state)
        half = self.line_length / 2
        line_end_1 = torch.stack([half * torch.cos(rot), half * torch.sin(rot)], dim=-1)
        line_end_2 = -line_end_1
        ang_vel_abs = torch.abs(self.line.ang_vel(state))
        return torch.cat(
            [
                agent.pos(state),
                agent.vel(state),
                self.line.pos(state) - agent.pos(state),
                line_end_1 - agent.pos(state),
                line_end_2 - agent.pos(state),
                F._mod_pi(rot)[:, None],
                ang_vel_abs[:, None],
                torch.abs(ang_vel_abs - self.desired_velocity)[:, None],
            ],
            dim=-1,
        )

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return WheelOutputs(self, world)


class WheelOutputs(F.FusedOutputs):
    """Wheel's observations and reward as extra rows of the fused step.
    ``emit`` mirrors pre_rewards/observation line for line (the plain
    version); the kernel's WheelEmit computes the same rows from the
    constants of ``kernel_emit``.

    Rows: per agent pos, vel, line - agent, each line end - agent, the
    line's rotation mod pi, its angular speed and the reward term (13); then
    the reward term |speed - v_des|."""

    obs_w = 13
    n_scratch_in = 0
    carry_extra_idx = ()  # no scratch: rows-rollout eligible

    def __init__(self, scenario, world):
        self.agent_i = [a.index for a in world.policy_agents]
        self.n_agents = A = len(self.agent_i)
        self.line_i = scenario.line.index
        self.half = scenario.line_length / 2
        self.v_des = float(scenario.desired_velocity)
        self.n_out = A * self.obs_w + 1
        self._kernel_emit = None

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        li = self.line_i
        rot_l, w_l = ctx["rot"][li], ctx["w"][li]
        lx, ly = px[li], py[li]
        e1x, e1y = self.half * torch.cos(rot_l), self.half * torch.sin(rot_l)
        ang_abs = torch.abs(w_l)
        rew = torch.abs(ang_abs - self.v_des)
        rmod = F._mod_pi(rot_l)
        rows = []
        for ai in self.agent_i:
            rows += [
                px[ai], py[ai], vx[ai], vy[ai],
                lx - px[ai], ly - py[ai],
                e1x - px[ai], e1y - py[ai],
                -e1x - px[ai], -e1y - py[ai],
                rmod, ang_abs, rew,
            ]
        rows.append(rew)
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through."""
        A, w = self.n_agents, self.obs_w
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        rew = extra[..., A * w, :]
        rews = tuple(-rew for _ in range(A))
        return obs, rews, torch.zeros(rew.shape, dtype=torch.bool, device=rew.device), {"rew": rew}

    def kernel_emit(self):
        if self._kernel_emit is None:
            ep = K.EmitParams()
            p = ep.wheel
            p.n_agents, p.line, p.half, p.v_des = self.n_agents, self.line_i, self.half, self.v_des
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            self._kernel_emit = (K.EMIT_WHEEL, ep)
        return self._kernel_emit


class HeuristicPolicy(BaseHeuristicPolicy):
    """The JAX package's wheel policy: head for the line's second end turned
    by pi/4 about the pivot."""

    def compute_action(self, observation, u_range):
        assert self.continuous_actions is True, "Heuristic for continuous actions only"
        pos_agent = observation[:, :2]
        pos_end2 = observation[:, 8:10] + pos_agent
        angle = torch.full((pos_end2.shape[0],), math.pi / 4, device=observation.device)
        shifted = TorchUtils.rotate_vector(pos_end2, angle)
        return torch.clamp(shifted - pos_agent, -u_range, u_range)
