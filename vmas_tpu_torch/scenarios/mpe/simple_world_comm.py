"""MPE simple_world_comm: adversaries led by a speaking leader chase good
agents that collect food and hide in forests.

Counterpart of vmas_tpu/scenarios/mpe/simple_world_comm.py, with its
fidelity notes: the reference's in-forest writes and its first prey-forest
block change copies and never the state, and its adversary shaping term
measures an agent's distance to itself, so this port reproduces what they
leave: ``in_forest`` stays -1, a non-leader sees zeros for the other agents,
and the adversaries' shaping term is zero. Its outputs come out of the fused
step as rows (``SimpleWorldCommOutputs``), which mirror ``reward`` and
``observation``; unpack reads the leader's comm state (``unpack_reads =
("c",)``).
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios.mpe.simple import along, hit_distance, index_run, radius_classes
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        num_good_agents = kwargs.pop("num_good_agents", 2)
        num_adversaries = kwargs.pop("num_adversaries", 4)
        num_landmarks = kwargs.pop("num_landmarks", 1)
        num_food = kwargs.pop("num_food", 2)
        num_forests = kwargs.pop("num_forests", 2)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim=batch_dim, device=device, x_semidim=1, y_semidim=1, dim_c=4)
        for i in range(num_good_agents + num_adversaries):
            adversary = i < num_adversaries
            leader = i == 0
            name = ("lead_adversary_0" if leader
                    else (f"adversary_{i}" if adversary else f"agent_{i - num_adversaries}"))
            agent = Agent(
                name=name, collide=True, shape=Sphere(radius=0.075 if adversary else 0.045),
                u_multiplier=3.0 if adversary else 4.0, max_speed=1.0 if adversary else 1.3,
                color=Color.RED if adversary else Color.GREEN, adversary=adversary, silent=not leader,
            )
            agent.leader = leader
            world.add_agent(agent)
        self.obstacles, self.food, self.forests = [], [], []
        for i in range(num_landmarks):
            lm = Landmark(name=f"landmark {i}", collide=True, shape=Sphere(radius=0.2))
            self.obstacles.append(lm)
            world.add_landmark(lm)
        for i in range(num_food):
            lm = Landmark(name=f"food {i}", collide=False, shape=Sphere(radius=0.03))
            self.food.append(lm)
            world.add_landmark(lm)
        for i in range(num_forests):
            lm = Landmark(name=f"forest {i}", collide=False, shape=Sphere(radius=0.3))
            self.forests.append(lm)
            world.add_landmark(lm)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        for agent in self.world.agents:
            state = agent.set_pos(state, torch.rand((B, 2), generator=generator, device=dev) * 2 - 1)
        for lm in self.world.landmarks:
            state = lm.set_pos(state, torch.rand((B, 2), generator=generator, device=dev) * 1.8 - 0.9)
        return state

    def is_collision(self, state, a, b):
        return safe_norm(a.pos(state) - b.pos(state)) < hit_distance(a.shape.radius, b.shape.radius)

    def good_agents(self):
        return [a for a in self.world.agents if not a.adversary]

    def adversaries(self):
        return [a for a in self.world.agents if a.adversary]

    def reward(self, agent, state):
        rew = torch.zeros((state.batch_dim,), dtype=torch.float32, device=state.device)
        if agent.adversary:
            # the shaping term is identically zero in the reference
            if agent.collide:
                for ag in self.good_agents():
                    for adv in self.adversaries():
                        rew = rew + 5.0 * self.is_collision(state, ag, adv).to(torch.float32)
            return rew
        if agent.collide:
            for a in self.adversaries():
                rew = rew - 5.0 * self.is_collision(state, a, agent).to(torch.float32)
        for food in self.food:
            rew = rew + 2.0 * self.is_collision(state, agent, food).to(torch.float32)
        dists = torch.stack([safe_norm(f.pos(state) - agent.pos(state)) for f in self.food], dim=1)
        return rew - 0.05 * torch.min(dists, dim=-1).values

    def observation(self, agent, state):
        B, dev = state.batch_dim, state.device
        entity_pos = [lm.pos(state) - agent.pos(state) for lm in self.world.landmarks]
        in_forest = torch.full((B, len(self.forests)), -1.0, dtype=torch.float32, device=dev)
        zeros = torch.zeros((B, 2), dtype=torch.float32, device=dev)
        other_pos, other_vel = [], []
        for other in self.world.agents:
            if other is agent:
                continue
            for _ in self.forests:
                if agent.leader:
                    other_pos.append(other.pos(state) - agent.pos(state))
                    other_vel.append(zeros if other.adversary else other.vel(state))
                else:
                    other_pos.append(zeros)
                    other_vel.append(zeros)
        comm = self.world.agents[0].comm(state)
        return torch.cat(
            [agent.vel(state), agent.pos(state), *entity_pos, *other_pos, *other_vel, in_forest]
            + ([comm] if (agent.adversary or agent.leader) else []),
            dim=-1,
        )

    def make_fused_outputs(self, world):
        return SimpleWorldCommOutputs(world, self)


class SimpleWorldCommOutputs(F.FusedOutputs):
    """simple_world_comm's observations and rewards as extra rows of the
    fused step: per agent its velocity, position and each landmark's pos -
    its own, and for the leader each other agent's pos - its own and each
    other good agent's velocity, once (``row_w``), then per agent its
    reward. unpack repeats the leader's rows per forest as the hook does
    and adds the constant blocks (a non-leader's zero rows, ``in_forest``)
    and the leader's comm state. No scratch."""

    n_scratch_in = 0
    carry_extra_idx = ()  # no kernel-read scratch: rows-rollout eligible
    unpack_reads = ("c",)  # the rows rollouts give unpack the per-step comm state

    def __init__(self, world, sc):
        agents = world.policy_agents
        self.agent_i = [a.index for a in agents]
        self.slot0 = agents[0].slot
        self.adv = [bool(a.adversary) for a in agents]
        self.leader = [bool(getattr(a, "leader", False)) for a in agents]
        self.collide = [bool(a.collide) for a in agents]
        self.radii = [float(a.shape.radius) for a in agents]
        self.lm_i = [lm.index for lm in world.landmarks]
        self.food_i = [f.index for f in sc.food]
        self.food_r = float(sc.food[0].shape.radius)
        self.n_forests = len(sc.forests)
        self.n_agents = A = len(agents)
        L = len(self.lm_i)
        lead_w = 2 * (A - 1) + 2 * sum(1 for j in range(A) if not self.adv[j])
        self.row_w = [4 + 2 * L + (lead_w - (0 if self.adv[i] else 2) if self.leader[i] else 0) for i in range(A)]
        self.offs = [sum(self.row_w[:i]) for i in range(A)]
        self.base = sum(self.row_w)
        self.n_out = self.base + A
        self._kernel_emit = None

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        e, A = self.agent_i, self.n_agents

        def hit(a, b, thr):
            return (F._norm(px[a] - px[b], py[a] - py[b]) < thr).to(torch.float32)

        rows = []
        for i in range(A):
            a = e[i]
            rows += [vx[a], vy[a], px[a], py[a]]
            for li in self.lm_i:
                rows += [px[li] - px[a], py[li] - py[a]]
            if self.leader[i]:
                others = [j for j in range(A) if j != i]
                rows += [r for j in others for r in (px[e[j]] - px[a], py[e[j]] - py[a])]
                rows += [r for j in others if not self.adv[j] for r in (vx[e[j]], vy[e[j]])]
        goods = [j for j in range(A) if not self.adv[j]]
        advs = [j for j in range(A) if self.adv[j]]
        adv_rew = None
        for g in goods:
            for j in advs:
                t = 5.0 * hit(e[g], e[j], hit_distance(self.radii[g], self.radii[j]))
                adv_rew = t if adv_rew is None else adv_rew + t
        rews = []
        for i in range(A):
            a = e[i]
            if self.adv[i]:
                rews.append(adv_rew if self.collide[i] else torch.zeros_like(px[0]))
                continue
            r = torch.zeros_like(px[0])
            if self.collide[i]:
                for j in advs:
                    r = r - 5.0 * hit(e[j], a, hit_distance(self.radii[j], self.radii[i]))
            for f in self.food_i:
                r = r + 2.0 * hit(a, f, hit_distance(self.radii[i], self.food_r))
            m = None
            for f in self.food_i:
                d = F._norm(px[f] - px[a], py[f] - py[a])
                m = d if m is None else torch.minimum(m, d)
            rews.append(r - 0.05 * m)
        return rows + rews

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, {}); a
        leading rollout axis passes through, and ``state.c`` may carry it
        too ([T, B, A, dim_c])."""
        A, L2, nf = self.n_agents, 2 * len(self.lm_i), self.n_forests
        lead = extra.shape[:-2] + extra.shape[-1:]  # [..., B]
        zeros2 = torch.zeros(lead + (2,), dtype=torch.float32, device=extra.device)
        in_forest = torch.full(lead + (nf,), -1.0, dtype=torch.float32, device=extra.device)
        comm = state.c[..., self.slot0, :]
        obs = []
        for i in range(A):
            o = extra[..., self.offs[i]:self.offs[i] + self.row_w[i], :].transpose(-1, -2)
            if self.leader[i]:
                # the emitted rows: each other agent's pos, then each other
                # good agent's vel; the hook repeats each once per forest
                others = [j for j in range(A) if j != i]
                c = 4 + L2 + 2 * len(others)
                pos_at = {j: o[..., 4 + L2 + 2 * k:4 + L2 + 2 * k + 2] for k, j in enumerate(others)}
                vel_at = {}
                for j in others:
                    if not self.adv[j]:
                        vel_at[j], c = o[..., c:c + 2], c + 2
                other_pos = [pos_at[j] for j in others for _ in range(nf)]
                other_vel = [vel_at.get(j, zeros2) for j in others for _ in range(nf)]
            else:
                other_pos = other_vel = [zeros2] * ((A - 1) * nf)
            parts = [o[..., :4 + L2], *other_pos, *other_vel, in_forest]
            if self.adv[i] or self.leader[i]:
                parts.append(along(comm, o))
            obs.append(torch.cat(parts, dim=-1))
        rews = tuple(extra[..., self.base + i, :] for i in range(A))
        return tuple(obs), rews, torch.zeros_like(rews[0], dtype=torch.bool), {}

    def kernel_emit(self):
        if self._kernel_emit is None:
            if self.n_agents > K.MAX_A:
                raise NotImplementedError(f"the fused kernel's MPE emits take at most {K.MAX_A} agents")
            ep = K.EmitParams()
            p = ep.simple_world_comm
            p.a0, p.n_agents = index_run(self.agent_i, "agents")
            p.l0, p.n_lm = index_run(self.lm_i, "landmarks")
            p.f0, p.n_food = index_run(self.food_i, "food")
            rcls, radii = radius_classes(self.radii)
            for i in range(self.n_agents):
                p.adversary[i], p.leader[i] = self.adv[i], self.leader[i]
                p.collide[i], p.rcls[i] = self.collide[i], rcls[i]
            for ci, ra in enumerate(radii):
                p.food_r[ci] = hit_distance(ra, self.food_r)
                for cj, rb in enumerate(radii):
                    p.hit_r[ci * K.MAX_RC + cj] = hit_distance(ra, rb)
            self._kernel_emit = (K.EMIT_SIMPLE_WORLD_COMM, ep)
        return self._kernel_emit
