"""MPE simple_spread: agents should cover the landmarks between them without
colliding; one shared reward. It is the original VMAS paper's speed protocol
(3 agents, discrete actions).

Counterpart of vmas_tpu/scenarios/mpe/simple_spread.py. Its outputs come out
of the fused step as rows (``SimpleSpreadOutputs``), which mirror
``pre_rewards`` and ``observation``.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.mpe.simple import index_run, uniform_positions
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        num_agents = kwargs.pop("n_agents", 3)
        self.obs_agents = kwargs.pop("obs_agents", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim=batch_dim, device=device)
        for i in range(num_agents):
            world.add_agent(Agent(name=f"agent_{i}", collide=True, shape=Sphere(radius=0.15), color=Color.BLUE))
        for i in range(num_agents):
            world.add_landmark(Landmark(name=f"landmark {i}", collide=False, color=Color.BLACK))
        return world

    def reset_world_at(self, state, generator):
        state = uniform_positions(generator, self.world.agents, state)
        state = uniform_positions(generator, self.world.landmarks, state)
        scratch = dict(state.scenario)
        scratch["rew"] = torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)
        return state.replace(scenario=scratch)

    def pre_rewards(self, state):
        agents = self.world.agents
        a_pos = state.pos[:, [a.index for a in agents]]  # [B, A, 2]
        l_pos = state.pos[:, [lm.index for lm in self.world.landmarks]]  # [B, L, 2]
        # the nearest agent's distance to each landmark, summed over the
        # landmarks, times the number of agents
        dist = safe_norm(a_pos[:, :, None, :] - l_pos[:, None, :, :])  # [B, A, L]
        rew = -torch.sum(torch.min(dist, dim=1).values, dim=-1) * len(agents)
        # minus one per overlapping ordered pair of agents
        for single_agent in agents:
            if single_agent.collide:
                for a in agents:
                    if a is not single_agent:
                        rew = rew - self.world.is_overlapping(state, a, single_agent).to(torch.float32)
        scratch = dict(state.scenario)
        scratch["rew"] = rew
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["rew"]

    def observation(self, agent, state):
        landmark_pos = [lm.pos(state) - agent.pos(state) for lm in self.world.landmarks]
        other_pos = [other.pos(state) - agent.pos(state) for other in self.world.agents if other is not agent]
        return torch.cat(
            [agent.pos(state), agent.vel(state), *landmark_pos, *(other_pos if self.obs_agents else [])], dim=-1
        )

    def make_fused_outputs(self, world):
        return SimpleSpreadOutputs(world, self.obs_agents)


class SimpleSpreadOutputs(F.FusedOutputs):
    """simple_spread's observations and reward as extra rows of the fused
    step: per agent pos, vel, each landmark's pos - the agent's and, with
    ``obs_agents``, each other agent's (``obs_w``), then the shared reward
    row. No scratch."""

    n_scratch_in = 0
    carry_extra_idx = ()  # no kernel-read scratch: rows-rollout eligible

    def __init__(self, world, obs_others):
        agents = world.policy_agents
        self.agent_i = [a.index for a in agents]
        self.lm_i = [lm.index for lm in world.landmarks]
        self.radii = [float(a.shape.radius) for a in agents]
        self.obs_others = bool(obs_others)
        self.n_agents = A = len(agents)
        self.obs_w = 4 + 2 * len(self.lm_i) + (2 * (A - 1) if self.obs_others else 0)
        self.base = A * self.obs_w
        self.n_out = self.base + 1
        self._kernel_emit = None

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        A, ai = self.n_agents, self.agent_i
        closest_sum = None
        for li in self.lm_i:
            closest = None
            for a in ai:
                d = F._norm(px[a] - px[li], py[a] - py[li])
                closest = d if closest is None else torch.minimum(closest, d)
            closest_sum = closest if closest_sum is None else closest_sum + closest
        rew = -closest_sum * float(A)
        for i in range(A):
            for j in range(A):
                if i != j:
                    d = F._norm(px[ai[i]] - px[ai[j]], py[ai[i]] - py[ai[j]])
                    rew = rew - (d - self.radii[i] - self.radii[j] < 0).to(torch.float32)
        rows = []
        for a in ai:
            rows += [px[a], py[a], vx[a], vy[a]]
            for li in self.lm_i:
                rows += [px[li] - px[a], py[li] - py[a]]
            if self.obs_others:
                for b in ai:
                    if b != a:
                        rows += [px[b] - px[a], py[b] - py[a]]
        return rows + [rew]

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, {"rew"}); a
        leading rollout axis passes through."""
        A, w = self.n_agents, self.obs_w
        obs = tuple(extra[..., i * w:(i + 1) * w, :].transpose(-1, -2) for i in range(A))
        rew = extra[..., self.base, :]
        return obs, (rew,) * A, torch.zeros_like(rew, dtype=torch.bool), {"rew": rew}

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A:
                raise NotImplementedError(f"the fused kernel's simple_spread emit takes at most {K.MAX_A} agents")
            ep = K.EmitParams()
            p = ep.simple_spread
            p.a0, p.n_agents = index_run(self.agent_i, "agents")
            p.l0, p.n_lm = index_run(self.lm_i, "landmarks")
            p.obs_others = self.obs_others
            for i, r in enumerate(self.radii):
                p.radius[i] = r
            self._kernel_emit = (K.EMIT_SIMPLE_SPREAD, ep)
        return self._kernel_emit
