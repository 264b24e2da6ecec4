"""MPE simple_push: a good agent goes to its goal landmark; an adversary,
which does not know the goal, pushes it away.

Counterpart of vmas_tpu/scenarios/mpe/simple_push.py. The goal landmark's
index is per-env scratch (``goal_idx``), drawn at reset; the colors a good
agent observes are computed from it. Its outputs come out of the fused step
as rows (``SimplePushOutputs``), which mirror ``reward`` and
``observation``.
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

# landmark i's color: [0.1, 0.1, 0.1] with channel i + 1 raised by 0.8
LANDMARK_COLORS = ((0.1, 0.9, 0.1), (0.1, 0.1, 0.9))


def _colors(goal_idx):
    """The good agent's color (0.25 with channel goal + 1 raised by 0.5) and
    the landmarks' colors, each [B, 3]."""
    B, dev = goal_idx.shape[0], goal_idx.device
    agent = torch.full((B, 3), 0.25, device=dev) + 0.5 * torch.nn.functional.one_hot(goal_idx.long() + 1, 3)
    lms = [torch.tensor(c, dtype=torch.float32, device=dev).expand(B, 3) for c in LANDMARK_COLORS]
    return agent.to(torch.float32), lms


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        ScenarioUtils.check_kwargs_consumed(kwargs)
        world = World(batch_dim=batch_dim, device=device)
        world.add_agent(Agent(name="adversary_0", collide=True, adversary=True))
        world.add_agent(Agent(name="agent_0", collide=True, adversary=False))
        for i in range(2):
            world.add_landmark(Landmark(name=f"landmark {i}", collide=False))
        return world

    def reset_world_at(self, state, generator):
        state = uniform_positions(generator, self.world.agents, state)
        state = uniform_positions(generator, self.world.landmarks, state)
        scratch = dict(state.scenario)
        scratch["goal_idx"] = torch.randint(0, 2, (state.batch_dim,), generator=generator, device=state.device)
        return state.replace(scenario=scratch)

    def _goal_pos(self, state):
        l_pos = state.pos[:, [lm.index for lm in self.world.landmarks]]
        idx = state.scenario["goal_idx"].long()
        return torch.take_along_dim(l_pos, idx[:, None, None], dim=1)[:, 0]

    def reward(self, agent, state):
        goal = self._goal_pos(state)
        if agent.adversary:
            goods = [safe_norm(a.pos(state) - goal) for a in self.world.agents if not a.adversary]
            pos_rew = torch.min(torch.stack(goods, dim=1), dim=-1).values
            return pos_rew - safe_norm(goal - agent.pos(state))
        return -safe_norm(agent.pos(state) - goal)

    def observation(self, agent, state):
        entity_pos = [lm.pos(state) - agent.pos(state) for lm in self.world.landmarks]
        other_pos = [o.pos(state) - agent.pos(state) for o in self.world.agents if o is not agent]
        if not agent.adversary:
            agent_color, entity_color = _colors(state.scenario["goal_idx"])
            return torch.cat([agent.vel(state), self._goal_pos(state) - agent.pos(state), agent_color,
                              *entity_pos, *entity_color, *other_pos], dim=-1)
        return torch.cat([agent.vel(state), *entity_pos, *other_pos], dim=-1)

    def make_fused_outputs(self, world):
        return SimplePushOutputs(world)


class SimplePushOutputs(F.FusedOutputs):
    """simple_push's observations and rewards as extra rows of the fused
    step: per agent its velocity, the goal's pos - its own (good agents
    only), each landmark's and each other agent's (``row_w``), then per
    agent the reward. The goal is picked per env from the ``goal_idx``
    scratch row, which rides the rows carry unchanged; unpack adds the
    constant color blocks."""

    n_scratch_in = 1  # goal_idx
    carry_extra_idx = (None,)  # chosen at reset, unchanged over a rollout

    def __init__(self, world):
        agents = world.policy_agents
        self.agent_i = [a.index for a in agents]
        self.adv = [bool(a.adversary) for a in agents]
        self.lm_i = [lm.index for lm in world.landmarks]
        self.n_agents = A = len(agents)
        L = len(self.lm_i)
        self.row_w = [2 + (0 if adv else 2) + 2 * L + 2 * (A - 1) for adv in self.adv]
        self.offs = [sum(self.row_w[:i]) for i in range(A)]
        self.base = sum(self.row_w)
        self.n_out = self.base + A
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["goal_idx"].to(torch.float32)[None]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        gidx = ctx["scratch"][0]
        ai_, lm = self.agent_i, self.lm_i
        gx = F._one_hot_select(gidx, [px[li] for li in lm])
        gy = F._one_hot_select(gidx, [py[li] for li in lm])
        rows, rews = [], []
        for i, a in enumerate(ai_):
            rows += [vx[a], vy[a]]
            if not self.adv[i]:
                rows += [gx - px[a], gy - py[a]]
            for li in lm:
                rows += [px[li] - px[a], py[li] - py[a]]
            for b in ai_:
                if b != a:
                    rows += [px[b] - px[a], py[b] - py[a]]
        for i, a in enumerate(ai_):
            if self.adv[i]:
                pos_rew = None
                for j, b in enumerate(ai_):
                    if not self.adv[j]:
                        d = F._norm(px[b] - gx, py[b] - gy)
                        pos_rew = d if pos_rew is None else torch.minimum(pos_rew, d)
                rews.append(pos_rew - F._norm(gx - px[a], gy - py[a]))
            else:
                rews.append(-F._norm(px[a] - gx, py[a] - gy))
        return rows + rews

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, {}); a
        leading rollout axis passes through."""
        L2 = 2 * len(self.lm_i)
        agent_color, entity_color = _colors(state.scenario["goal_idx"])
        obs = []
        for i in range(self.n_agents):
            o = extra[..., self.offs[i]:self.offs[i] + self.row_w[i], :].transpose(-1, -2)
            if not self.adv[i]:
                # the hook's order: vel, the goal's rel, the agent's color,
                # the landmarks' rels, their colors, the other agents' rels
                o = torch.cat([o[..., :4], along(agent_color, o), o[..., 4:4 + L2],
                               *(along(c, o) for c in entity_color), o[..., 4 + L2:]], dim=-1)
            obs.append(o)
        rews = tuple(extra[..., self.base + i, :] for i in range(self.n_agents))
        return tuple(obs), rews, torch.zeros_like(rews[0], dtype=torch.bool), {}

    def kernel_emit(self):
        if self._kernel_emit is None:
            self._kernel_emit = (K.EMIT_SIMPLE_PUSH, team_params(self, "simple_push"))
        return self._kernel_emit


def team_params(fo, member):
    """simple_push's or simple_adversary's kernel parameters (``member`` of
    ``EmitParams``): the agents' and landmarks' runs and the adversary
    flags; the goal_idx scratch row is carried unchanged."""
    if fo.n_agents > K.MAX_A:
        raise NotImplementedError(f"the fused kernel's MPE emits take at most {K.MAX_A} agents")
    ep = K.EmitParams()
    ep.carry_idx[0] = -1
    p = getattr(ep, member)
    p.a0, p.n_agents = index_run(fo.agent_i, "agents")
    p.l0, p.n_lm = index_run(fo.lm_i, "landmarks")
    for i, adv in enumerate(fo.adv):
        p.adversary[i] = adv
    return ep
