"""MPE simple_reference: two agents, each of which knows the landmark the
other should reach and tells it over a 10-dimensional channel.

Counterpart of vmas_tpu/scenarios/mpe/simple_reference.py. The goal
landmarks' indices are per-env scratch (``goal_b_0``, ``goal_b_1``), drawn
at reset; the goal color an agent observes is its landmark's fixed color.
Its outputs come out of the fused step as rows (``SimpleReferenceOutputs``),
which mirror ``reward`` and ``observation``; unpack reads the other agent's
comm state (``unpack_reads = ("c",)``).
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Landmark, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.mpe.simple import along, index_run, uniform_positions
from vmas_tpu_torch.utils import ScenarioUtils

LANDMARK_COLORS = ((0.75, 0.25, 0.25), (0.25, 0.75, 0.25), (0.25, 0.25, 0.75))


def goal_colors(idx, colors):
    """The fixed colors of the landmarks ``idx`` [B] picks, [B, 3]."""
    return torch.tensor(colors, dtype=torch.float32, device=idx.device)[idx.long()]


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        ScenarioUtils.check_kwargs_consumed(kwargs)
        world = World(batch_dim=batch_dim, device=device, dim_c=10)
        for i in range(2):
            world.add_agent(Agent(name=f"agent_{i}", collide=False, silent=False))
        for i in range(3):
            world.add_landmark(Landmark(name=f"landmark {i}", collide=False))
        return world

    def reset_world_at(self, state, generator):
        state = uniform_positions(generator, self.world.agents, state)
        state = uniform_positions(generator, self.world.landmarks, state)
        scratch = dict(state.scenario)
        # agent i wants the OTHER agent at landmark goal_b_i
        for i in range(2):
            scratch[f"goal_b_{i}"] = torch.randint(0, 3, (state.batch_dim,), generator=generator,
                                                   device=state.device)
        return state.replace(scenario=scratch)

    def _goal_b_pos(self, state, i):
        l_pos = state.pos[:, [lm.index for lm in self.world.landmarks]]
        idx = state.scenario[f"goal_b_{i}"].long()
        return torch.take_along_dim(l_pos, idx[:, None, None], dim=1)[:, 0]

    def reward(self, agent, state):
        # the sum over the agents of minus the other agent's distance to the
        # agent's goal landmark
        rew = torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)
        for i, a in enumerate(self.world.agents):
            goal_a = self.world.agents[1 - i]
            rew = rew - safe_norm(goal_a.pos(state) - self._goal_b_pos(state, i))
        return rew

    def observation(self, agent, state):
        goal_color = goal_colors(state.scenario[f"goal_b_{agent.slot}"], LANDMARK_COLORS)
        entity_pos = [lm.pos(state) - agent.pos(state) for lm in self.world.landmarks]
        comm = [o.comm(state) for o in self.world.agents if o is not agent]
        return torch.cat([agent.vel(state), *entity_pos, goal_color, *comm], dim=-1)

    def make_fused_outputs(self, world):
        return SimpleReferenceOutputs(world)


class SimpleReferenceOutputs(F.FusedOutputs):
    """simple_reference's observations and reward as extra rows of the
    fused step: per agent its velocity and each landmark's pos - its own
    (``row_w``), then the shared reward. The goals are picked per env from
    the ``goal_b_i`` scratch rows, which ride the rows carry unchanged;
    unpack adds the goal color and the other agent's comm state."""

    carry_extra_idx = (None, None)  # chosen at reset, unchanged over a rollout
    unpack_reads = ("c",)  # the rows rollouts give unpack the per-step comm state

    def __init__(self, world):
        agents = world.policy_agents
        self.agent_i = [a.index for a in agents]
        self.slots = [a.slot for a in agents]
        self.lm_i = [lm.index for lm in world.landmarks]
        self.n_agents = A = len(agents)
        if A != 2:
            raise ValueError(f"simple_reference has two agents, got {A}")
        self.n_scratch_in = A  # goal_b_i per agent
        self.row_w = 2 + 2 * len(self.lm_i)
        self.base = A * self.row_w
        self.n_out = self.base + 1
        self._kernel_emit = None

    def scratch_rows(self, state):
        return torch.stack([state.scenario[f"goal_b_{i}"].to(torch.float32) for i in range(self.n_agents)])

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        gidx = ctx["scratch"]
        e, lm = self.agent_i, self.lm_i
        rows = []
        for a in e:
            rows += [vx[a], vy[a]]
            for li in lm:
                rows += [px[li] - px[a], py[li] - py[a]]
        rew = None
        for i in range(self.n_agents):
            goal_a = e[1 - i]
            gx = F._one_hot_select(gidx[i], [px[li] for li in lm])
            gy = F._one_hot_select(gidx[i], [py[li] for li in lm])
            d = -F._norm(px[goal_a] - gx, py[goal_a] - gy)
            rew = d if rew is None else rew + d
        return rows + [rew]

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, {}); a
        leading rollout axis passes through, and ``state.c`` may carry it
        too ([T, B, A, dim_c])."""
        A, w = self.n_agents, self.row_w
        rew = extra[..., self.base, :]
        obs = []
        for i in range(A):
            o = extra[..., i * w:(i + 1) * w, :].transpose(-1, -2)
            color = goal_colors(state.scenario[f"goal_b_{i}"], LANDMARK_COLORS)
            comm = [state.c[..., s, :] for j, s in enumerate(self.slots) if j != i]
            obs.append(torch.cat([o, along(color, o), *(along(c, o) for c in comm)], dim=-1))
        return tuple(obs), (rew,) * A, torch.zeros_like(rew, dtype=torch.bool), {}

    def kernel_emit(self):
        if self._kernel_emit is None:
            ep = K.EmitParams()
            ep.carry_idx[0] = ep.carry_idx[1] = -1
            p = ep.simple_reference
            p.a0, p.n_agents = index_run(self.agent_i, "agents")
            p.l0, p.n_lm = index_run(self.lm_i, "landmarks")
            self._kernel_emit = (K.EMIT_SIMPLE_REFERENCE, ep)
        return self._kernel_emit
