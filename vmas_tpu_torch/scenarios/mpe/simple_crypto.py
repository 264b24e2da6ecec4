"""MPE simple_crypto: Alice speaks a secret encrypted with a key that she
shares with Bob; Eve, without the key, tries to read it too.

Counterpart of vmas_tpu/scenarios/mpe/simple_crypto.py. The per-env binary
key and secret live in scenario scratch, drawn at reset. Every agent is
immovable and speaks; the JAX package has no fused outputs for this
scenario, so it steps through the hooks (``env.step``, ``rollout_fn``).
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.core import Agent, Color, World
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        dim_c = kwargs.pop("dim_c", 4)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        assert dim_c > 0
        self.dim_c = dim_c

        world = World(batch_dim=batch_dim, device=device, dim_c=dim_c)
        for i in range(3):
            adversary = i < 1
            speaker = i == 2
            agent = Agent(
                name=("eve_0" if adversary else ("alice_0" if speaker else "bob_0")),
                collide=False, movable=False,
                color=(Color.RED if adversary else (Color.GREEN if speaker else Color.BLUE)),
                adversary=adversary, silent=False,
            )
            agent.speaker = speaker
            world.add_agent(agent)
        return world

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        for agent in self.world.agents:
            state = agent.set_pos(state, torch.rand((B, 2), generator=generator, device=dev) * 2 - 1)
        scratch = dict(state.scenario)
        for k in ("key", "secret"):
            scratch[k] = torch.randint(0, 2, (B, self.dim_c), generator=generator, device=dev).to(torch.float32)
        return state.replace(scenario=scratch)

    def good_listeners(self):
        return [a for a in self.world.agents if not a.adversary and not a.speaker]

    def adversaries(self):
        return [a for a in self.world.agents if a.adversary]

    def _masked_sq_err(self, state, a, secret):
        """The squared error of agent ``a``'s comm state against the secret,
        0 where it says nothing (all zeros)."""
        c = a.comm(state)
        zero_comms = torch.all(c == 0.0, dim=-1)
        err = torch.sum(torch.square(c - secret), dim=-1)
        return torch.where(zero_comms, 0.0, err)

    def reward(self, agent, state):
        secret = state.scenario["secret"]
        if agent.adversary:
            return -self._masked_sq_err(state, agent, secret)
        good = -sum(self._masked_sq_err(state, a, secret) for a in self.good_listeners())
        adv = sum(self._masked_sq_err(state, a, secret) for a in self.adversaries())
        return good + adv

    def observation(self, agent, state):
        comm = [o.comm(state) for o in self.world.agents if o is not agent and o.speaker]
        key, secret = state.scenario["key"], state.scenario["secret"]
        if agent.speaker:
            return torch.cat([secret, key], dim=-1)
        if not agent.adversary:
            return torch.cat([key, *comm], dim=-1)
        return torch.cat(comm, dim=-1)
