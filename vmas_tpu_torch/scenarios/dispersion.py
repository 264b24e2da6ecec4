"""Dispersion: N agents start at the origin and spread out to eat food; a
food item's reward is split among the agents on it (or shared).

Counterpart of vmas_tpu/scenarios/dispersion.py. The per-food attributes
(eaten, just_eaten, how_many_on_food) are ``[B, F]`` scratch tensors; the
reward bookkeeping is the pre_rewards and post_rewards hooks. Its outputs
come out of the fused step as rows (``DispersionOutputs``); post_rewards
still runs on the unpacked state (and once on a rows rollout's final
state: ``post_rewards_rollout_safe``).
"""

from __future__ import annotations

import numpy as np
import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, Landmark, Sphere, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 4)
        self.share_reward = kwargs.pop("share_reward", False)
        self.penalise_by_time = kwargs.pop("penalise_by_time", False)
        self.food_radius = kwargs.pop("food_radius", 0.05)
        self.pos_range = kwargs.pop("pos_range", 1.0)
        n_food = kwargs.pop("n_food", n_agents)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device, x_semidim=self.pos_range, y_semidim=self.pos_range)
        for i in range(n_agents):
            world.add_agent(Agent(name=f"agent_{i}", collide=False, shape=Sphere(radius=0.035)))
        for i in range(n_food):
            world.add_landmark(
                Landmark(name=f"food_{i}", collide=False, shape=Sphere(radius=self.food_radius), color=Color.GREEN)
            )
        self.n_food = n_food
        return world

    # ------------------------------------------------------------------
    def reset_world_at(self, state, generator):
        # the agents spawn at the origin (the state is zeroed)
        B, F_, dev = state.batch_dim, self.n_food, state.device
        for food in self.world.landmarks:
            pos = (torch.rand((B, 2), generator=generator, device=dev) * 2 - 1) * self.pos_range
            state = food.set_pos(state, pos)
            state = food.set_rendering(state, True)
        scratch = dict(state.scenario)
        scratch["eaten"] = torch.zeros((B, F_), dtype=torch.bool, device=dev)
        scratch["just_eaten"] = torch.zeros((B, F_), dtype=torch.bool, device=dev)
        scratch["how_many_on_food"] = torch.zeros((B, F_), dtype=torch.int32, device=dev)
        return state.replace(scenario=scratch)

    # ------------------------------------------------------------------
    def _food_pos(self, state):
        return state.pos[:, [f.index for f in self.world.landmarks]]  # [B, F, 2]

    def _agents_on_food(self, state):
        """[B, A, F] bool: agent within eating range of food."""
        a_pos = state.pos[:, [a.index for a in self.world.agents]]  # [B, A, 2]
        dist = safe_norm(a_pos[:, :, None, :] - self._food_pos(state)[:, None, :, :])
        radii = torch.tensor([a.shape.radius + self.food_radius for a in self.world.agents], dtype=torch.float32,
                             device=state.device)
        return dist < radii[None, :, None]

    def pre_rewards(self, state):
        on = self._agents_on_food(state)  # [B, A, F]
        how_many = on.sum(dim=1, dtype=torch.int32)  # [B, F]
        scratch = dict(state.scenario)
        scratch["how_many_on_food"] = how_many
        scratch["just_eaten"] = scratch["just_eaten"] | (how_many > 0)
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        eaten, just_eaten, how_many = s["eaten"], s["just_eaten"], s["how_many_on_food"]
        if self.share_reward:
            rews = (just_eaten & ~eaten).sum(dim=-1).to(torch.float32)
        else:
            on = self._agents_on_food(state)[:, agent.slot]  # [B, F]
            hm = how_many.to(torch.float32)
            eating_rew = torch.where(how_many > 0, F._rdiv(1.0, torch.where(how_many > 0, hm, 1.0)), 0.0)
            rews = torch.where(on & ~eaten, eating_rew, 0.0).sum(dim=-1)
        if self.penalise_by_time:
            rews = torch.where(rews == 0, -0.01, rews)
        return rews

    def post_rewards(self, state):
        scratch = dict(state.scenario)
        eaten = scratch["eaten"] | scratch["just_eaten"]
        scratch["eaten"] = eaten
        scratch["just_eaten"] = torch.zeros_like(eaten)
        # eaten food stops rendering
        rendering = state.rendering.clone()
        rendering[:, [f.index for f in self.world.landmarks]] = ~eaten
        return state.replace(scenario=scratch, rendering=rendering)

    # ------------------------------------------------------------------
    def observation(self, agent, state):
        rel = self._food_pos(state) - agent.pos(state)[:, None, :]  # [B, F, 2]
        eaten = state.scenario["eaten"].to(torch.float32)[..., None]  # [B, F, 1]
        per_food = torch.cat([rel, eaten], dim=-1).reshape(state.batch_dim, -1)
        return torch.cat([agent.pos(state), agent.vel(state), per_food], dim=-1)

    def done(self, state):
        return torch.all(state.scenario["eaten"], dim=-1)

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return DispersionOutputs(self, world)


class DispersionOutputs(F.FusedOutputs):
    """Dispersion's observations, rewards and done as extra rows of the fused
    step. ``emit`` mirrors pre_rewards/reward/observation/done (the plain
    version; the kernel's DispersionEmit); the observation and done rows use
    eaten | just_eaten, as the hook pipeline computes them after
    post_rewards, which still runs on the unpacked state.

    Rows: per agent pos, vel (4); per agent each food item's pos - the
    agent's (2F); per food item just_eaten, eaten (merged) and how many
    agents are on it (3F); per agent the reward; done. Scratch in: eaten,
    then just_eaten."""

    agent_w = 4
    # post_rewards merges eaten | just_eaten (the emitted eaten row already),
    # zeroes just_eaten and toggles the food's rendering: applied once to a
    # rows rollout's final state, it gives the hook pipeline's
    post_rewards_rollout_safe = True

    def __init__(self, scenario, world):
        self.agent_i = [a.index for a in world.policy_agents]
        self.food_i = [f.index for f in world.landmarks]
        self.n_agents = A = len(self.agent_i)
        self.n_food = F_ = len(self.food_i)
        # each agent's eating range: the double sum of the two radii the JAX
        # package compares against, rounded once to f32
        self.eat_r = [float(np.float32(float(a.shape.radius) + float(scenario.food_radius)))
                      for a in world.policy_agents]
        self.share = bool(scenario.share_reward)
        self.by_time = bool(scenario.penalise_by_time)
        self.n_scratch_in = 2 * F_
        self.o_just = A * self.agent_w + 2 * A * F_
        self.o_eaten, self.o_hm, self.o_rew = self.o_just + F_, self.o_just + 2 * F_, self.o_just + 3 * F_
        self.n_out = self.o_rew + A + 1
        # rows-carried rollout: the next step's eaten rows are this step's
        # emitted eaten rows; just_eaten is zero at every step's entry
        # (post_rewards zeroes it), so it is carried unchanged
        self.carry_extra_idx = tuple(self.o_eaten + k for k in range(F_)) + (None,) * F_
        self._kernel_emit = None

    @staticmethod
    def scratch_rows(state):
        return torch.cat([state.scenario["eaten"].to(torch.float32).T,
                          state.scenario["just_eaten"].to(torch.float32).T])  # [2F, B]

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        A, F_ = self.n_agents, self.n_food
        eaten = [r > 0.5 for r in ctx["scratch"][:F_]]
        just_prev = [r > 0.5 for r in ctx["scratch"][F_:]]

        rel, on = {}, {}
        for i, ai in enumerate(self.agent_i):
            for k, fk in enumerate(self.food_i):
                rx, ry = px[fk] - px[ai], py[fk] - py[ai]
                rel[(i, k)] = (rx, ry)
                on[(i, k)] = F._norm(rx, ry) < self.eat_r[i]
        how_many = [sum(on[(i, k)].to(torch.float32) for i in range(A)) for k in range(F_)]
        just_new = [just_prev[k] | (how_many[k] > 0) for k in range(F_)]
        eaten_new = [eaten[k] | just_new[k] for k in range(F_)]

        rews = []
        for i in range(A):
            if self.share:
                r = sum((just_new[k] & ~eaten[k]).to(torch.float32) for k in range(F_))
            else:
                r = None
                for k in range(F_):
                    hm = how_many[k]
                    eat = torch.where(hm > 0, F._rdiv(1.0, torch.where(hm > 0, hm, 1.0)), 0.0)
                    term = torch.where(on[(i, k)] & ~eaten[k], eat, 0.0)
                    r = term if r is None else r + term
            if self.by_time:
                r = torch.where(r == 0, -0.01, r)
            rews.append(r)
        done = eaten_new[0]
        for e in eaten_new[1:]:
            done = done & e

        rows = []
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai]]
        for i in range(A):
            for k in range(F_):
                rows += list(rel[(i, k)])
        rows += [j.to(torch.float32) for j in just_new]
        rows += [e.to(torch.float32) for e in eaten_new]
        rows += how_many
        rows += rews
        rows.append(done.to(torch.float32))
        return rows

    def unpack(self, extra, state):
        """Emit rows [..., n_out, B] -> (obs, rews, terminated, scratch
        updates); a leading rollout axis passes through. Each agent's
        observation: pos, vel, then per food item its offset and the merged
        eaten flag."""
        A, F_, w = self.n_agents, self.n_food, self.agent_w
        obs = []
        for i in range(A):
            # slices, not an index list: a list is copied from the host at
            # every call, which a CUDA graph's capture refuses
            parts = [extra[..., i * w:(i + 1) * w, :]]
            for k in range(F_):
                r = A * w + (i * F_ + k) * 2
                parts += [extra[..., r:r + 2, :], extra[..., self.o_eaten + k:self.o_eaten + k + 1, :]]
            obs.append(torch.cat(parts, dim=-2).transpose(-1, -2))
        just = extra[..., self.o_just:self.o_just + F_, :].transpose(-1, -2) > 0.5
        eaten = extra[..., self.o_eaten:self.o_eaten + F_, :].transpose(-1, -2) > 0.5
        how_many = extra[..., self.o_hm:self.o_hm + F_, :].transpose(-1, -2).to(torch.int32)
        rews = tuple(extra[..., self.o_rew + i, :] for i in range(A))
        done = extra[..., self.o_rew + A, :] > 0.5
        # post_rewards merges eaten | just_eaten again: the same value
        return tuple(obs), rews, done, {"eaten": eaten, "just_eaten": just, "how_many_on_food": how_many}

    def kernel_emit(self):
        if self._kernel_emit is None:
            ep = K.EmitParams()
            for k, ei in enumerate(self.carry_extra_idx):
                ep.carry_idx[k] = -1 if ei is None else int(ei)
            p = ep.dispersion
            p.n_agents, p.n_food, p.share, p.by_time = self.n_agents, self.n_food, self.share, self.by_time
            for i, ai in enumerate(self.agent_i):
                p.agent[i], p.eat_r[i] = ai, self.eat_r[i]
            for k, fk in enumerate(self.food_i):
                p.food[k] = fk
            self._kernel_emit = (K.EMIT_DISPERSION, ep)
        return self._kernel_emit
