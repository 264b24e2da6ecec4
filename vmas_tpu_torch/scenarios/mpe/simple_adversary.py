"""MPE simple_adversary: the good agents know which landmark is the goal and
cover it; the adversaries do not know it and try to reach it.

Counterpart of vmas_tpu/scenarios/mpe/simple_adversary.py. The goal
landmark's index is per-env scratch (``goal_idx``), drawn at reset. Its
outputs come out of the fused step as rows (``SimpleAdversaryOutputs``),
which mirror ``reward`` and ``observation``.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.mpe.simple import uniform_positions
from vmas_tpu_torch.scenarios.mpe.simple_push import team_params
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 3)
        n_adversaries = kwargs.pop("n_adversaries", 1)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        assert n_agents > n_adversaries

        world = World(batch_dim=batch_dim, device=device)
        for i in range(n_agents):
            adversary = i < n_adversaries
            name = f"adversary_{i}" if adversary else f"agent_{i - n_adversaries}"
            world.add_agent(Agent(name=name, collide=False, shape=Sphere(radius=0.15),
                                  color=Color.RED if adversary else Color.BLUE, adversary=adversary))
        for i in range(n_agents - 1):
            world.add_landmark(Landmark(name=f"landmark {i}", collide=False, shape=Sphere(radius=0.08),
                                        color=Color.BLACK))
        return world

    def reset_world_at(self, state, generator):
        state = uniform_positions(generator, self.world.agents, state)
        state = uniform_positions(generator, self.world.landmarks, state)
        scratch = dict(state.scenario)
        scratch["goal_idx"] = torch.randint(0, len(self.world.landmarks), (state.batch_dim,), generator=generator,
                                            device=state.device)
        return state.replace(scenario=scratch)

    def _goal_pos(self, state):
        l_pos = state.pos[:, [lm.index for lm in self.world.landmarks]]
        idx = state.scenario["goal_idx"].long()
        return torch.take_along_dim(l_pos, idx[:, None, None], dim=1)[:, 0]

    def good_agents(self):
        return [a for a in self.world.agents if not a.adversary]

    def adversaries(self):
        return [a for a in self.world.agents if a.adversary]

    def reward(self, agent, state):
        return self.adversary_reward(agent, state) if agent.adversary else self.agent_reward(agent, state)

    def agent_reward(self, agent, state):
        goal = self._goal_pos(state)
        adv_rew = sum(safe_norm(a.pos(state) - goal) for a in self.adversaries())
        goods = torch.stack([safe_norm(a.pos(state) - goal) for a in self.good_agents()], dim=1)
        pos_rew = -torch.min(goods, dim=-1).values
        return pos_rew + adv_rew

    def adversary_reward(self, agent, state):
        return -safe_norm(agent.pos(state) - self._goal_pos(state))

    def observation(self, agent, state):
        entity_pos = [lm.pos(state) - agent.pos(state) for lm in self.world.landmarks]
        other_pos = [o.pos(state) - agent.pos(state) for o in self.world.agents if o is not agent]
        if not agent.adversary:
            return torch.cat([self._goal_pos(state) - agent.pos(state), *entity_pos, *other_pos], dim=-1)
        return torch.cat([*entity_pos, *other_pos], dim=-1)

    def make_fused_outputs(self, world):
        return SimpleAdversaryOutputs(world)


class SimpleAdversaryOutputs(F.FusedOutputs):
    """simple_adversary's observations and rewards as extra rows of the
    fused step: per agent the goal's pos - its own (good agents only), each
    landmark's and each other agent's (``row_w``), then per agent the
    reward. The goal is picked per env from the ``goal_idx`` scratch row,
    which rides the rows carry unchanged."""

    n_scratch_in = 1  # goal_idx
    carry_extra_idx = (None,)  # chosen at reset, unchanged over a rollout

    def __init__(self, world):
        agents = world.policy_agents
        self.agent_i = [a.index for a in agents]
        self.adv = [bool(a.adversary) for a in agents]
        self.lm_i = [lm.index for lm in world.landmarks]
        self.n_agents = A = len(agents)
        L = len(self.lm_i)
        self.row_w = [(0 if adv else 2) + 2 * L + 2 * (A - 1) for adv in self.adv]
        self.offs = [sum(self.row_w[:i]) for i in range(A)]
        self.base = sum(self.row_w)
        self.n_out = self.base + A
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return state.scenario["goal_idx"].to(torch.float32)[None]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        gidx = ctx["scratch"][0]
        ai_, lm = self.agent_i, self.lm_i
        gx = F._one_hot_select(gidx, [px[li] for li in lm])
        gy = F._one_hot_select(gidx, [py[li] for li in lm])
        rows = []
        for i, a in enumerate(ai_):
            if not self.adv[i]:
                rows += [gx - px[a], gy - py[a]]
            for li in lm:
                rows += [px[li] - px[a], py[li] - py[a]]
            for b in ai_:
                if b != a:
                    rows += [px[b] - px[a], py[b] - py[a]]
        adv_sum = sum(F._norm(px[a] - gx, py[a] - gy) for i, a in enumerate(ai_) if self.adv[i])
        good_min = None
        for i, a in enumerate(ai_):
            if not self.adv[i]:
                d = F._norm(px[a] - gx, py[a] - gy)
                good_min = d if good_min is None else torch.minimum(good_min, d)
        rews = [-F._norm(px[a] - gx, py[a] - gy) if self.adv[i] else -good_min + adv_sum
                for i, a in enumerate(ai_)]
        return rows + rews

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, {}); a
        leading rollout axis passes through."""
        obs = tuple(extra[..., o:o + w, :].transpose(-1, -2) for o, w in zip(self.offs, self.row_w))
        rews = tuple(extra[..., self.base + i, :] for i in range(self.n_agents))
        return obs, rews, torch.zeros_like(rews[0], dtype=torch.bool), {}

    def kernel_emit(self):
        if self._kernel_emit is None:
            self._kernel_emit = (K.EMIT_SIMPLE_ADVERSARY, team_params(self, "simple_adversary"))
        return self._kernel_emit
