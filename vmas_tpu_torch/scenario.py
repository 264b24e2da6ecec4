"""Scenario author API.

Counterpart of vmas_tpu/scenario.py. The hooks are functions over a
:class:`WorldState`:

* ``make_world(batch_dim, device, **kwargs)`` builds the world;
* ``reset_world_at(state, generator) -> state`` resets ALL envs; the
  environment blends the result under a ``[B]`` mask;
* ``observation(agent, state)`` / ``reward(agent, state)`` are pure reads;
* ``pre_rewards(state)`` / ``post_rewards(state)`` hold the cross-agent
  reward bookkeeping, kept in ``state.scenario`` scratch;
* ``process_action(agent, state)``, ``pre_step``, ``post_step`` as in VMAS;
* ``make_fused_outputs(world)`` (optional) returns a ``fused.FusedOutputs``;
* ``obs_generator(i)`` gives agent ``i``'s observation-noise stream;
* ``extra_render(env, ax, env_index)`` / ``top_layer_render`` draw onto
  the frame's matplotlib ``Axes``, below and above the entities, from the
  frame's host copy of the state (``env.state`` there lies on the CPU).
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
        # the observation-noise seed of the current step or reset, set by
        # the environment before the observation hooks run
        self.obs_seed: int = 0

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

    def obs_generator(self, i: int = 0) -> torch.Generator:
        """Agent ``i``'s observation-noise stream for this step (or reset):
        a ``torch.Generator`` on the world's device, seeded from the fresh
        seed the environment draws for each step and each reset
        (``self.obs_seed``) and from ``i``, so that each agent draws from a
        stream of its own. The counterpart of the JAX package's
        ``obs_key(state, i)``."""
        seed = (self.obs_seed + (i + 1) * _GOLDEN64) % 2**64
        return torch.Generator(device=self.world.device).manual_seed(seed)

    def extra_render(self, env, ax, env_index: int = 0) -> None:
        """Draw scenario-specific geoms BELOW the entity layer. ``env`` is
        the viewer's view of the environment: its ``state`` is the frame's
        host copy (``render/viewer.py``), so a hook reads no device tensor;
        ``ax`` is the frame's matplotlib Axes; paint with the
        :mod:`vmas_tpu_torch.render.draw` helpers."""

    def top_layer_render(self, env, ax, env_index: int = 0) -> None:
        """Like :meth:`extra_render`, drawn ABOVE the entity layer."""


# odd 64-bit constant that spreads consecutive agent indices over the seed space
_GOLDEN64 = 0x9E3779B97F4A7C15


class BaseHeuristicPolicy(ABC):
    """A scripted policy of one agent: ``compute_action(observation [B,
    obs_dim], u_range) -> action [B, action_size]`` (the JAX package's
    BaseHeuristicPolicy)."""

    def __init__(self, continuous_action: bool):
        self.continuous_actions = continuous_action

    @abstractmethod
    def compute_action(self, observation: torch.Tensor, u_range) -> torch.Tensor: ...


class RandomPolicy(BaseHeuristicPolicy):
    """Uniform actions in [-u_range, u_range]^2, drawn from a generator
    seeded by the observations (the JAX package keys its draw on them the
    same way; the draws differ, as torch's and JAX's streams do)."""

    def compute_action(self, observation, u_range):
        seed = int(torch.sum(observation * 1e3)) & 0x7FFFFFFF
        g = torch.Generator(device=observation.device).manual_seed(seed)
        u = torch.rand((observation.shape[0], 2), generator=g, device=observation.device)
        return u * (2 * u_range) - u_range
