"""MPE simple_tag (predator-prey): slower adversaries chase faster good
agents among colliding landmarks.

Counterpart of vmas_tpu/scenarios/mpe/simple_tag.py.
The per-agent rewards are computed in ``pre_rewards``; with
``respawn_at_catch`` a caught good agent is moved to a random position there,
drawing from the step's seeded stream (``obs_generator``). Its outputs come
out of the fused step as rows (``SimpleTagOutputs``), which mirror
``pre_rewards``, ``reward`` and ``observation``; ``respawn_at_catch`` moves
state in ``pre_rewards``, which the rows cannot express, so that config
keeps the hook pipeline.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.mpe.simple import hit_distance, index_run, radius_classes
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        num_good_agents = kwargs.pop("num_good_agents", 1)
        num_adversaries = kwargs.pop("num_adversaries", 3)
        num_landmarks = kwargs.pop("num_landmarks", 2)
        self.shape_agent_rew = kwargs.pop("shape_agent_rew", False)
        self.shape_adversary_rew = kwargs.pop("shape_adversary_rew", False)
        self.agents_share_rew = kwargs.pop("agents_share_rew", False)
        self.adversaries_share_rew = kwargs.pop("adversaries_share_rew", True)
        self.observe_same_team = kwargs.pop("observe_same_team", True)
        self.observe_pos = kwargs.pop("observe_pos", True)
        self.observe_vel = kwargs.pop("observe_vel", True)
        self.bound = kwargs.pop("bound", 1.0)
        self.respawn_at_catch = kwargs.pop("respawn_at_catch", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        # the viewer's settings (render/viewer.py)
        self.visualize_semidims = False

        world = World(batch_dim=batch_dim, device=device, x_semidim=self.bound, y_semidim=self.bound,
                      substeps=10, collision_force=500)
        self.adversary_radius = 0.075
        for i in range(num_adversaries + num_good_agents):
            adversary = i < num_adversaries
            name = f"adversary_{i}" if adversary else f"agent_{i - num_adversaries}"
            world.add_agent(Agent(
                name=name, collide=True, shape=Sphere(radius=self.adversary_radius if adversary else 0.05),
                u_multiplier=3.0 if adversary else 4.0, max_speed=1.0 if adversary else 1.3,
                color=Color.RED if adversary else Color.GREEN, adversary=adversary,
            ))
        for i in range(num_landmarks):
            world.add_landmark(Landmark(name=f"landmark {i}", collide=True, shape=Sphere(radius=0.2),
                                        color=Color.BLACK))
        return world

    def reset_world_at(self, state, generator):
        B, dev, bound = state.batch_dim, state.device, self.bound
        for agent in self.world.agents:
            state = agent.set_pos(state, torch.rand((B, 2), generator=generator, device=dev) * (2 * bound) - bound)
        inner = bound - 0.1
        for lm in self.world.landmarks:
            state = lm.set_pos(state, torch.rand((B, 2), generator=generator, device=dev) * (2 * inner) - inner)
        scratch = dict(state.scenario)
        scratch["agents_rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch["adversary_rew"] = torch.zeros((B,), dtype=torch.float32, device=dev)
        scratch["per_agent_rew"] = torch.zeros((B, len(self.world.agents)), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def is_collision(self, state, a, b):
        dist = safe_norm(a.pos(state) - b.pos(state))
        return dist < hit_distance(a.shape.radius, b.shape.radius)

    def good_agents(self):
        return [a for a in self.world.agents if not a.adversary]

    def adversaries(self):
        return [a for a in self.world.agents if a.adversary]

    def _agent_reward(self, state, agent):
        rew = torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)
        for adv in self.adversaries():
            if self.shape_agent_rew:
                rew = rew + 0.1 * safe_norm(agent.pos(state) - adv.pos(state))
            if agent.collide:
                rew = rew - 10.0 * self.is_collision(state, adv, agent).to(torch.float32)
        return rew

    def _adversary_reward(self, state, agent):
        rew = torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)
        agents = self.good_agents()
        if self.shape_adversary_rew:
            dists = torch.stack([safe_norm(a.pos(state) - agent.pos(state)) for a in agents], dim=-1)
            rew = rew - 0.1 * torch.min(dists, dim=-1).values
        if agent.collide:
            for ag in agents:
                rew = rew + 10.0 * self.is_collision(state, ag, agent).to(torch.float32)
        return rew

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        per_agent = torch.stack([
            self._adversary_reward(state, a) if a.adversary else self._agent_reward(state, a)
            for a in self.world.agents
        ], dim=-1)  # [B, A]
        good = torch.tensor([not a.adversary for a in self.world.agents], device=state.device)
        scratch["per_agent_rew"] = per_agent
        scratch["agents_rew"] = torch.where(good, per_agent, 0.0).sum(-1)
        scratch["adversary_rew"] = torch.where(~good, per_agent, 0.0).sum(-1)
        if self.respawn_at_catch:
            B, dev = state.batch_dim, state.device
            for a in self.good_agents():
                caught = torch.zeros((B,), dtype=torch.bool, device=dev)
                for adv in self.adversaries():
                    caught = caught | self.is_collision(state, a, adv)
                gen = self.obs_generator(1000 + a.slot)
                new_pos = torch.rand((B, 2), generator=gen, device=dev) * (2 * self.bound) - self.bound
                state = a.set_pos(state, new_pos, env_mask=caught)
                state = a.set_vel(state, torch.zeros((B, 2), device=dev), env_mask=caught)
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        if agent.adversary:
            return s["adversary_rew"] if self.adversaries_share_rew else s["per_agent_rew"][:, agent.slot]
        return s["agents_rew"] if self.agents_share_rew else s["per_agent_rew"][:, agent.slot]

    def observation(self, agent, state):
        entity_pos = [lm.pos(state) - agent.pos(state) for lm in self.world.landmarks]
        other_pos, other_vel = [], []
        for other in self.world.agents:
            if other is agent:
                continue
            if agent.adversary and not other.adversary:
                other_pos.append(other.pos(state) - agent.pos(state))
                other_vel.append(other.vel(state))
            elif not agent.adversary and not other.adversary and self.observe_same_team:
                other_pos.append(other.pos(state) - agent.pos(state))
                other_vel.append(other.vel(state))
            elif not agent.adversary and other.adversary:
                other_pos.append(other.pos(state) - agent.pos(state))
            elif agent.adversary and other.adversary and self.observe_same_team:
                other_pos.append(other.pos(state) - agent.pos(state))
        return torch.cat([
            *([agent.vel(state)] if self.observe_vel else []),
            *([agent.pos(state)] if self.observe_pos else []),
            *entity_pos, *other_pos, *other_vel,
        ], dim=-1)

    def make_fused_outputs(self, world):
        if self.respawn_at_catch:
            return None
        return SimpleTagOutputs(world, self)

    def extra_render(self, env, ax, env_index: int = 0):
        """The arena's perimeter."""
        from vmas_tpu_torch.render import draw

        draw.draw_perimeter(ax, self.bound, pad=self.adversary_radius)


class SimpleTagOutputs(F.FusedOutputs):
    """simple_tag's observations and rewards as extra rows of the fused
    step: per agent its velocity and position (where observed), each
    landmark's pos - its own, its position partners' and its velocity
    partners' rows (``partners``, in the hook's order: ``row_w``), then per
    agent its reward, the hook's terms in the hook's order. unpack builds
    the team sums and the shared rewards. No scratch."""

    n_scratch_in = 0
    carry_extra_idx = ()  # no kernel-read scratch: rows-rollout eligible

    def __init__(self, world, sc):
        agents = world.policy_agents
        self.agent_i = [a.index for a in agents]
        self.adv = [bool(a.adversary) for a in agents]
        self.collide = [bool(a.collide) for a in agents]
        self.radii = [float(a.shape.radius) for a in agents]
        self.lm_i = [lm.index for lm in world.landmarks]
        self.shape_agent = bool(sc.shape_agent_rew)
        self.shape_adv = bool(sc.shape_adversary_rew)
        self.share_agents = bool(sc.agents_share_rew)
        self.share_advs = bool(sc.adversaries_share_rew)
        self.same_team = bool(sc.observe_same_team)
        self.obs_pos = bool(sc.observe_pos)
        self.obs_vel = bool(sc.observe_vel)
        self.n_agents = A = len(agents)
        self.partners = [self._partners(i) for i in range(A)]
        L = len(self.lm_i)
        self.row_w = [(2 if self.obs_vel else 0) + (2 if self.obs_pos else 0) + 2 * L + 2 * len(p) + 2 * len(v)
                      for p, v in self.partners]
        self.offs = [sum(self.row_w[:i]) for i in range(A)]
        self.base = sum(self.row_w)
        self.n_out = self.base + A
        self._kernel_emit = None

    def _partners(self, i):
        """Agent i's (position partners, velocity partners), slots in the
        hook's order."""
        pos_p, vel_p = [], []
        for j in range(self.n_agents):
            if j == i:
                continue
            if self.adv[i] != self.adv[j] or self.same_team:
                pos_p.append(j)
            if not self.adv[j] and (self.adv[i] or self.same_team):
                vel_p.append(j)
        return pos_p, vel_p

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        e = self.agent_i

        def collide(i, j):
            d = F._norm(px[e[i]] - px[e[j]], py[e[i]] - py[e[j]])
            return (d < hit_distance(self.radii[i], self.radii[j])).to(torch.float32)

        rows = []
        for i, (pos_p, vel_p) in enumerate(self.partners):
            a = e[i]
            if self.obs_vel:
                rows += [vx[a], vy[a]]
            if self.obs_pos:
                rows += [px[a], py[a]]
            for li in self.lm_i:
                rows += [px[li] - px[a], py[li] - py[a]]
            rows += [r for j in pos_p for r in (px[e[j]] - px[a], py[e[j]] - py[a])]
            rows += [r for j in vel_p for r in (vx[e[j]], vy[e[j]])]
        goods = [j for j in range(self.n_agents) if not self.adv[j]]
        advs = [j for j in range(self.n_agents) if self.adv[j]]
        rews = []
        for i in range(self.n_agents):
            a, r = e[i], None
            if self.adv[i]:
                if self.shape_adv:
                    m = None
                    for g in goods:
                        d = F._norm(px[e[g]] - px[a], py[e[g]] - py[a])
                        m = d if m is None else torch.minimum(m, d)
                    r = -0.1 * m
                if self.collide[i]:
                    for g in goods:
                        hit = 10.0 * collide(g, i)
                        r = hit if r is None else r + hit
            else:
                for j in advs:
                    if self.shape_agent:
                        t = 0.1 * F._norm(px[a] - px[e[j]], py[a] - py[e[j]])
                        r = t if r is None else r + t
                    if self.collide[i]:
                        t = -10.0 * collide(j, i)
                        r = t if r is None else r + t
            rews.append(r if r is not None else torch.zeros_like(px[0]))
        return rows + rews

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, the reward
        scratch); a leading rollout axis passes through."""
        A = self.n_agents
        obs = tuple(extra[..., o:o + w, :].transpose(-1, -2) for o, w in zip(self.offs, self.row_w))
        per_agent = torch.stack([extra[..., self.base + i, :] for i in range(A)], dim=-1)  # [..., B, A]
        good = torch.tensor([not adv for adv in self.adv], device=extra.device)
        agents_rew = torch.where(good, per_agent, 0.0).sum(-1)
        adv_rew = torch.where(~good, per_agent, 0.0).sum(-1)
        rews = tuple(
            (adv_rew if self.share_advs else per_agent[..., i]) if self.adv[i]
            else (agents_rew if self.share_agents else per_agent[..., i])
            for i in range(A)
        )
        updates = {"per_agent_rew": per_agent, "agents_rew": agents_rew, "adversary_rew": adv_rew}
        return obs, rews, torch.zeros_like(agents_rew, dtype=torch.bool), updates

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A:
                raise NotImplementedError(f"the fused kernel's MPE emits take at most {K.MAX_A} agents")
            ep = K.EmitParams()
            p = ep.simple_tag
            p.a0, p.n_agents = index_run(self.agent_i, "agents")
            p.l0, p.n_lm = index_run(self.lm_i, "landmarks")
            rcls, radii = radius_classes(self.radii)
            for i in range(self.n_agents):
                p.adversary[i], p.collide[i], p.rcls[i] = self.adv[i], self.collide[i], rcls[i]
            for ci, ra in enumerate(radii):
                for cj, rb in enumerate(radii):
                    p.hit_r[ci * K.MAX_RC + cj] = hit_distance(ra, rb)
            p.shape_agent, p.shape_adv, p.same_team = self.shape_agent, self.shape_adv, self.same_team
            p.obs_pos, p.obs_vel = self.obs_pos, self.obs_vel
            self._kernel_emit = (K.EMIT_SIMPLE_TAG, ep)
        return self._kernel_emit
