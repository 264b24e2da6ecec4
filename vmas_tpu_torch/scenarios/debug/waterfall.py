"""Waterfall (debug): a chain of five agents joined by bars, the last one
joined to a box at a fixed relative rotation, falling past five box
obstacles onto a floor line.

Counterpart of vmas_tpu/scenarios/debug/waterfall.py. Its world holds all
six contact pair types and both kinds of joint constraint: rotating ones,
and two ``rotate=False`` ones whose fixed rotation is inferred when the
joints sync at reset. Its outputs come out of the fused step as rows
(``WaterfallOutputs``).
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Box, Color, Joint, Landmark, Line, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 5)
        self.with_joints = kwargs.pop("joints", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.agent_dist = 0.1
        self.agent_radius = 0.04

        world = World(batch_dim, device, dt=0.1, drag=0.25, substeps=5, collision_force=500)
        for i in range(self.n_agents):
            world.add_agent(
                Agent(name=f"agent_{i}", shape=Sphere(radius=self.agent_radius), u_multiplier=0.7, rotatable=True)
            )
        if self.with_joints:
            for i in range(self.n_agents - 1):
                world.add_joint(
                    Joint(
                        world.agents[i], world.agents[i + 1], anchor_a=(1, 0), anchor_b=(-1, 0),
                        dist=self.agent_dist, rotate_a=True, rotate_b=True, collidable=True, width=0, mass=1,
                    )
                )
            landmark = Landmark(
                name="joined landmark", collide=True, movable=True, rotatable=True,
                shape=Box(length=self.agent_radius * 2, width=0.3), color=Color.GREEN,
            )
            world.add_landmark(landmark)
            world.add_joint(
                Joint(
                    world.agents[-1], landmark, anchor_a=(1, 0), anchor_b=(-1, 0), dist=self.agent_dist,
                    rotate_a=False, rotate_b=False, collidable=True, width=0, mass=1,
                )
            )
        for i in range(5):
            world.add_landmark(
                Landmark(
                    name=f"landmark {i}", collide=True, movable=True, rotatable=True,
                    shape=Box(length=0.3, width=0.1), color=Color.RED,
                )
            )
        world.add_landmark(
            Landmark(name="floor", collide=True, movable=False, shape=Line(length=2), color=Color.BLACK)
        )
        return world

    def reset_world_at(self, state, generator):
        dev = state.device
        vec = lambda x, y: torch.tensor([x, y], dtype=torch.float32, device=dev)
        joined = [self.world.landmarks[self.n_agents - 1]] if self.with_joints else []
        for i, agent in enumerate(self.world.agents + joined):
            state = agent.set_pos(state, vec(-0.2 + (self.agent_dist + 2 * self.agent_radius) * i, 1.0))
        boxes = self.world.landmarks[(self.n_agents + 1) if self.with_joints else 0:-1]
        for i, landmark in enumerate(boxes):
            state = landmark.set_pos(state, vec(0.2 if i % 2 else -0.2, 0.6 - 0.3 * i))
            state = landmark.set_rot(
                state, torch.tensor(math.pi / 4 if i % 2 else -math.pi / 4, dtype=torch.float32, device=dev)
            )
        return self.world.landmarks[-1].set_pos(state, vec(0.0, -1.0))

    def reward(self, agent, state):
        return -safe_norm(agent.pos(state) - self.world.landmarks[-1].pos(state))

    def observation(self, agent, state):
        return torch.cat(
            [agent.pos(state), agent.vel(state)] + [lm.pos(state) - agent.pos(state) for lm in self.world.landmarks],
            dim=-1,
        )

    def make_fused_outputs(self, world):
        return WaterfallOutputs(world)


class WaterfallOutputs(F.FusedOutputs):
    """waterfall's observations and rewards as extra rows of the fused step:
    per agent pos, vel and each landmark's pos - the agent's (``obs_w``),
    then per agent the reward, minus its distance to the floor. No scratch:
    the joints' fixed rotations ride the carry."""

    n_scratch_in = 0
    carry_extra_idx = ()

    def __init__(self, world):
        self.agent_i = [a.index for a in world.policy_agents]
        self.lm_i = [lm.index for lm in world.landmarks]
        self.goal_i = world.landmarks[-1].index
        self.n_agents = A = len(self.agent_i)
        self.obs_w = 4 + 2 * len(self.lm_i)
        self.base = A * self.obs_w
        self.n_out = self.base + A
        self._kernel_emit = None

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rows, rews = [], []
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai]]
            for li in self.lm_i:
                rows += [px[li] - px[ai], py[li] - py[ai]]
            rews.append(-F._norm(px[ai] - px[self.goal_i], py[ai] - py[self.goal_i]))
        return rows + rews

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, {}); a
        leading rollout axis passes through."""
        A, w = self.n_agents, self.obs_w
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        rews = tuple(extra[..., self.base + i, :] for i in range(A))
        return obs, rews, torch.zeros_like(rews[0], dtype=torch.bool), {}

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A or len(self.lm_i) > K.MAX_E:
                raise NotImplementedError(
                    f"the fused kernel's waterfall emit takes at most {K.MAX_A} agents and {K.MAX_E} landmarks"
                )
            ep = K.EmitParams()
            p = ep.waterfall
            p.n_agents = self.n_agents
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            p.n_lm = len(self.lm_i)
            for k, li in enumerate(self.lm_i):
                p.lm[k] = li
            p.goal = self.goal_i
            self._kernel_emit = (K.EMIT_WATERFALL, ep)
        return self._kernel_emit
