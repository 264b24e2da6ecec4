"""Scenario author API.

Counterpart of vmas_tpu/scenario.py (rendering hooks not ported). The hooks
are functions over a :class:`WorldState`:

* ``make_world(batch_dim, device, **kwargs)`` builds the world;
* ``reset_world_at(state, generator) -> state`` resets ALL envs; the
  environment blends the result under a ``[B]`` mask;
* ``observation(agent, state)`` / ``reward(agent, state)`` are pure reads;
* ``pre_rewards(state)`` / ``post_rewards(state)`` hold the cross-agent
  reward bookkeeping, kept in ``state.scenario`` scratch;
* ``process_action(agent, state)``, ``pre_step``, ``post_step`` as in VMAS;
* ``make_fused_outputs(world)`` (optional) returns a ``fused.FusedOutputs``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Optional

import torch

from vmas_tpu_torch.core.state import WorldState
from vmas_tpu_torch.core.world import Agent, World


class BaseScenario(ABC):
    def __init__(self):
        """Do not override."""
        self._world: Optional[World] = None

    @property
    def world(self) -> World:
        assert self._world is not None, "You first need to set `self._world` in the `make_world` method"
        return self._world

    # -- environment-facing, do not override ----------------------------
    def env_make_world(self, batch_dim: int, device=None, **kwargs) -> World:
        self._world = self.make_world(batch_dim, device, **kwargs)
        self._world.finalize()
        return self._world

    def env_reset_world_at(self, state: WorldState, generator: torch.Generator) -> WorldState:
        """Zero the world state, run the scenario reset, re-sync joints; the
        caller blends the result under the reset mask."""
        state = self.world.zeroed(state)
        state = self.reset_world_at(state, generator)
        return self.world.sync_joints(state)

    def env_process_action(self, agent: Agent, state: WorldState) -> WorldState:
        if agent.action_script is not None:
            state = agent.action_script(agent, self.world, state)
        state = self.process_action(agent, state)
        return agent.dynamics.check_and_process_action(self.world, state)

    # -- required hooks --------------------------------------------------
    @abstractmethod
    def make_world(self, batch_dim: int, device=None, **kwargs) -> World: ...

    @abstractmethod
    def reset_world_at(self, state: WorldState, generator: torch.Generator) -> WorldState:
        """Reset of ALL envs; the environment applies the reset mask."""
        ...

    @abstractmethod
    def observation(self, agent: Agent, state: WorldState): ...

    def observations(self, state: WorldState):
        """Optional batch hook: all policy agents' observations at once, or
        None to use the per-agent ``observation`` calls."""
        return None

    @abstractmethod
    def reward(self, agent: Agent, state: WorldState): ...

    # -- optional hooks --------------------------------------------------
    def done(self, state: WorldState):
        return torch.zeros((state.batch_dim,), dtype=torch.bool, device=state.device)

    def info(self, agent: Agent, state: WorldState) -> Dict:
        return {}

    def pre_rewards(self, state: WorldState) -> WorldState:
        """Cross-agent bookkeeping before per-agent rewards."""
        return state

    def post_rewards(self, state: WorldState) -> WorldState:
        """Cross-agent bookkeeping after per-agent rewards."""
        return state

    def process_action(self, agent: Agent, state: WorldState) -> WorldState:
        return state

    def pre_step(self, state: WorldState) -> WorldState:
        return state

    def post_step(self, state: WorldState) -> WorldState:
        return state
