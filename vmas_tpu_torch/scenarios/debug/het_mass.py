"""Heterogeneous mass (debug): two agents of different masses, rewarded for
the larger speed and charged for the energy they spend; their actions move
them along x only.

Counterpart of vmas_tpu/scenarios/debug/het_mass.py: the masses are drawn
once, when the world is built, from ``np.random.RandomState(0)``, as the
JAX package draws them. Its outputs come out of the fused step as rows
(``HetMassOutputs``); the energy term reads the actions in ``unpack``. It
has no rows rollout: its ``process_action`` zeroes u's y outside the
kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core import Agent, Color, World
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import Y, safe_norm
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.green_mass = kwargs.pop("green_mass", 4)
        self.blue_mass = kwargs.pop("blue_mass", 2)
        self.mass_noise = kwargs.pop("mass_noise", 1)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        self.plot_grid = True

        rng = np.random.RandomState(0)
        world = World(batch_dim, device)
        self.green_agent = Agent(
            name="agent 0", collide=False, color=Color.GREEN, render_action=True,
            mass=float(self.green_mass + rng.uniform(-self.mass_noise, self.mass_noise)), f_range=1,
        )
        world.add_agent(self.green_agent)
        self.blue_agent = Agent(
            name="agent 1", collide=False, render_action=True,
            mass=float(self.blue_mass + rng.uniform(-self.mass_noise, self.mass_noise)), f_range=1,
        )
        world.add_agent(self.blue_agent)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        for agent in self.world.agents:
            state = agent.set_pos(state, torch.rand((B, 2), generator=generator, device=dev) * 2 - 1)
        scratch = dict(state.scenario)
        scratch.setdefault("max_speed", torch.zeros((B,), dtype=torch.float32, device=dev))
        scratch.setdefault("energy_expenditure", torch.zeros((B,), dtype=torch.float32, device=dev))
        return state.replace(scenario=scratch)

    def process_action(self, agent, state):
        u = agent.u(state).clone()
        u[:, Y] = 0.0
        return agent.set_u(state, u)

    def pre_rewards(self, state):
        scratch = dict(state.scenario)
        speeds = [safe_norm(a.vel(state)) for a in self.world.agents]
        scratch["max_speed"] = torch.max(torch.stack(speeds, dim=1), dim=1).values
        scratch["energy_expenditure"] = energy(self.world.agents, state, math.sqrt(self.world.dim_p * (1.0**2)))
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        return state.scenario["max_speed"] + state.scenario["energy_expenditure"]

    def observation(self, agent, state):
        return torch.cat([agent.pos(state), agent.vel(state)], dim=-1)

    def info(self, agent, state):
        return {
            "max_speed": state.scenario["max_speed"],
            "energy_expenditure": state.scenario["energy_expenditure"],
        }

    # ------------------------------------------------------------------
    def make_fused_outputs(self, world):
        return HetMassOutputs(self, world)


def energy(agents, state, denom):
    """``-sum_a |u_a| / denom * 0.17`` over the agents' actions (any leading
    axes), summed in agent order from the first term; each quotient one IEEE
    division."""
    total = None
    for a in agents:
        t = F._div(safe_norm(a.u(state)), denom)
        total = t if total is None else total + t
    return -total * 0.17


class HetMassOutputs(F.FusedOutputs):
    """het_mass's observations and the speed term of its reward as extra rows
    of the fused step (the plain version; the kernel's HetMassEmit). Not
    rows-eligible: no ``carry_extra_idx``, as the scenario's
    ``process_action`` runs outside the kernel.

    Rows: per agent pos, vel (4); then the largest agent speed."""

    n_scratch_in = 0

    def __init__(self, scenario, world):
        self.agents = world.policy_agents
        self.agent_i = [a.index for a in self.agents]
        self.n_agents = A = len(self.agent_i)
        self.denom = math.sqrt(world.dim_p * (1.0**2))
        self.n_out = 4 * A + 1
        self._kernel_emit = None

    def emit(self, ctx):
        px, py = ctx["px"], ctx["py"]
        vx, vy = ctx["vx"], ctx["vy"]
        rows, max_speed = [], None
        for ai in self.agent_i:
            rows += [px[ai], py[ai], vx[ai], vy[ai]]
            s = F._norm(vx[ai], vy[ai])
            max_speed = s if max_speed is None else torch.maximum(max_speed, s)
        rows.append(max_speed)
        return rows

    def unpack(self, extra, state):
        """Emit rows [n_out, B] -> (obs, rews, terminated, scratch updates);
        the energy term from the state's u, which process_action set."""
        A = self.n_agents
        obs = tuple(extra[..., i * 4:(i + 1) * 4, :].transpose(-1, -2) for i in range(A))
        max_speed = extra[..., 4 * A, :]
        en = energy(self.agents, state, self.denom)
        rew = max_speed + en
        done = torch.zeros(max_speed.shape, dtype=torch.bool, device=max_speed.device)
        return obs, tuple(rew for _ in range(A)), done, {"max_speed": max_speed, "energy_expenditure": en}

    def kernel_emit(self):
        if self._kernel_emit is None:
            ep = K.EmitParams()
            p = ep.het_mass
            p.n_agents = self.n_agents
            for i, ai in enumerate(self.agent_i):
                p.agent[i] = ai
            self._kernel_emit = (K.EMIT_HET_MASS, ep)
        return self._kernel_emit
