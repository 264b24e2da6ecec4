"""MPE simple_speaker_listener: an immovable speaker sees the goal
landmark's color and tells a silent listener where to go over a
3-dimensional channel.

Counterpart of vmas_tpu/scenarios/mpe/simple_speaker_listener.py. The goal
landmark's index is per-env scratch (``goal_idx``), drawn at reset; the goal
color the speaker observes is its landmark's fixed color. Its outputs come
out of the fused step as rows (``SpeakerListenerOutputs``), which mirror
``reward`` and ``observation``; unpack reads the speaker's comm state
(``unpack_reads = ("c",)``).
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.mpe.simple import along, index_run, uniform_positions
from vmas_tpu_torch.scenarios.mpe.simple_reference import goal_colors
from vmas_tpu_torch.utils import ScenarioUtils

LANDMARK_COLORS = ((0.65, 0.15, 0.15), (0.15, 0.65, 0.15), (0.15, 0.15, 0.65))


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        ScenarioUtils.check_kwargs_consumed(kwargs)
        world = World(batch_dim=batch_dim, device=device, dim_c=3)
        world.add_agent(Agent(name="speaker_0", collide=False, movable=False, silent=False,
                              shape=Sphere(radius=0.075)))
        world.add_agent(Agent(name="listener_0", collide=False, movable=True, silent=True,
                              shape=Sphere(radius=0.075)))
        for i in range(3):
            world.add_landmark(Landmark(name=f"landmark {i}", collide=False, shape=Sphere(radius=0.04)))
        return world

    def reset_world_at(self, state, generator):
        state = uniform_positions(generator, self.world.agents, state)
        state = uniform_positions(generator, self.world.landmarks, state)
        scratch = dict(state.scenario)
        scratch["goal_idx"] = torch.randint(0, 3, (state.batch_dim,), generator=generator, device=state.device)
        return state.replace(scenario=scratch)

    def _goal_pos(self, state):
        l_pos = state.pos[:, [lm.index for lm in self.world.landmarks]]
        idx = state.scenario["goal_idx"].long()
        return torch.take_along_dim(l_pos, idx[:, None, None], dim=1)[:, 0]

    def reward(self, agent, state):
        # minus the listener's distance to the goal, once per agent
        listener = self.world.agents[1]
        return -safe_norm(listener.pos(state) - self._goal_pos(state)) * len(self.world.agents)

    def observation(self, agent, state):
        goal_color = goal_colors(state.scenario["goal_idx"], LANDMARK_COLORS)
        if not agent.movable:  # the speaker
            return goal_color
        entity_pos = [lm.pos(state) - agent.pos(state) for lm in self.world.landmarks]
        comm = [o.comm(state) for o in self.world.agents if o is not agent]
        return torch.cat([agent.vel(state), *entity_pos, *comm], dim=-1)

    def make_fused_outputs(self, world):
        return SpeakerListenerOutputs(world)


class SpeakerListenerOutputs(F.FusedOutputs):
    """simple_speaker_listener's observations and reward as extra rows of
    the fused step: the listener's velocity and each landmark's pos - its
    own (``base`` rows), then the shared reward. The goal is picked per env
    from the ``goal_idx`` scratch row, which rides the rows carry unchanged;
    unpack assembles the speaker's goal color and the listener's view of
    the speaker's comm state."""

    n_scratch_in = 1  # goal_idx
    carry_extra_idx = (None,)  # chosen at reset, unchanged over a rollout
    unpack_reads = ("c",)  # the rows rollouts give unpack the per-step comm state

    def __init__(self, world):
        agents = world.policy_agents
        self.n_agents = len(agents)
        self.listener = agents[1].index
        self.speaker_slots = [a.slot for a in agents if a is not agents[1]]
        self.lm_i = [lm.index for lm in world.landmarks]
        self.base = 2 + 2 * len(self.lm_i)  # the listener's rows
        self.n_out = self.base + 1
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["goal_idx"].to(torch.float32)[None]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        gidx = ctx["scratch"][0]
        li, lm = self.listener, self.lm_i
        gx = F._one_hot_select(gidx, [px[k] for k in lm])
        gy = F._one_hot_select(gidx, [py[k] for k in lm])
        rows = [vx[li], vy[li]]
        for k in lm:
            rows += [px[k] - px[li], py[k] - py[li]]
        return rows + [-F._norm(px[li] - gx, py[li] - gy) * float(self.n_agents)]

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, {}); a
        leading rollout axis passes through, and ``state.c`` may carry it
        too ([T, B, A, dim_c])."""
        o = extra[..., :self.base, :].transpose(-1, -2)
        comm = [state.c[..., s, :] for s in self.speaker_slots]
        goal_color = goal_colors(state.scenario["goal_idx"], LANDMARK_COLORS)
        obs = (along(goal_color, o), torch.cat([o, *(along(c, o) for c in comm)], dim=-1))
        rew = extra[..., self.base, :]
        return obs, (rew,) * self.n_agents, torch.zeros_like(rew, dtype=torch.bool), {}

    def kernel_emit(self):
        if self._kernel_emit is None:
            ep = K.EmitParams()
            ep.carry_idx[0] = -1
            p = ep.speaker_listener
            p.n_agents, p.listener = self.n_agents, self.listener
            p.l0, p.n_lm = index_run(self.lm_i, "landmarks")
            self._kernel_emit = (K.EMIT_SPEAKER_LISTENER, ep)
        return self._kernel_emit
