"""The DOTS extension: a walled arena, agents with a knowledge state, a
virtual comms-network agent and goals with an expected knowledge.

Counterpart of vmas_tpu/dots_core.py. The extra per-entity state (an
agent's knowledge and seeking flag, a goal's expected knowledge) lives in
the scenario scratch under the JAX package's entity-keyed names
(``__dots_knowledge_<name>``, ``__dots_seeking_<name>``,
``__dots_expected_<name>``); the handles read and write it.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.core import Agent, Box, Color, Landmark, World
from vmas_tpu_torch.core.state import WorldState


class DOTSWorld(World):
    """A world with four walls around a square arena of side
    ``arena_size``."""

    def __init__(self, batch_dim, device=None, **kwargs):
        super().__init__(batch_dim, device, **kwargs)
        self.walls = None
        self.arena_size = 5
        self.viewer_zoom = 1.7

    def spawn_map(self):
        self.walls = []
        for i in range(4):
            wall = Landmark(
                name=f"wall_{i}", collide=True,
                shape=Box(length=self.arena_size + 0.1, width=0.1), color=Color.BLACK,
            )
            self.walls.append(wall)
            self.add_landmark(wall)

    def reset_map(self, state: WorldState) -> WorldState:
        half = self.arena_size / 2
        for i, wall in enumerate(self.walls):
            x = -half if i == 0 else (half if i == 1 else 0.0)
            y = -half if i == 2 else (half if i == 3 else 0.0)
            state = wall.set_pos(state, torch.tensor([x, y], dtype=torch.float32, device=state.device))
            state = wall.set_rot(state, torch.tensor(math.pi / 2 if i < 2 else 0.0, dtype=torch.float32,
                                                     device=state.device))
        return state


class DOTSAgent(Agent):
    """An agent with a knowledge state ``[B, *knowledge_shape]`` and a
    seeking-goal flag ``[B]``."""

    def __init__(self, name, knowledge_shape=None, **kwargs):
        super().__init__(name, **kwargs)
        self.knowledge_shape = knowledge_shape

    def _kkey(self):
        return f"__dots_knowledge_{self.name}"

    def _skey(self):
        return f"__dots_seeking_{self.name}"

    def spawn_dots_state(self, state: WorldState) -> WorldState:
        B, dev = state.batch_dim, state.device
        scratch = dict(state.scenario)
        scratch[self._skey()] = torch.zeros((B,), dtype=torch.bool, device=dev)
        if self.knowledge_shape is not None:
            scratch[self._kkey()] = torch.zeros((B,) + tuple(self.knowledge_shape), dtype=torch.float32, device=dev)
        return state.replace(scenario=scratch)

    def knowledge(self, state: WorldState):
        return state.scenario[self._kkey()]

    def set_knowledge(self, state: WorldState, knowledge, env_mask=None) -> WorldState:
        scratch = dict(state.scenario)
        knowledge = torch.as_tensor(knowledge, dtype=torch.float32, device=state.device)
        if env_mask is not None:
            m = env_mask.reshape((-1,) + (1,) * (knowledge.ndim - 1))
            knowledge = torch.where(m, knowledge, scratch[self._kkey()])
        scratch[self._kkey()] = knowledge
        return state.replace(scenario=scratch)

    def seeking_goal(self, state: WorldState):
        return state.scenario[self._skey()]

    def set_seeking_goal(self, state: WorldState, value) -> WorldState:
        scratch = dict(state.scenario)
        scratch[self._skey()] = value
        return state.replace(scenario=scratch)


class DOTSComsNetwork(Agent):
    """A virtual comms-network agent: not movable, not rotatable, no
    collisions (unless the caller says otherwise)."""

    def __init__(self, name, **kwargs):
        kwargs.setdefault("movable", False)
        kwargs.setdefault("rotatable", False)
        kwargs.setdefault("collide", False)
        super().__init__(name, **kwargs)


class DOTSPayloadDest(Landmark):
    """A goal landmark with an expected knowledge ``[B,
    expected_knowledge_shape]``."""

    def __init__(self, expected_knowledge_shape=None, **kwargs):
        super().__init__(**kwargs)
        self.expected_knowledge_shape = expected_knowledge_shape

    def _ekey(self):
        return f"__dots_expected_{self.name}"

    def spawn_dots_state(self, state: WorldState) -> WorldState:
        scratch = dict(state.scenario)
        if self.expected_knowledge_shape is not None:
            scratch[self._ekey()] = torch.zeros((state.batch_dim, self.expected_knowledge_shape),
                                                dtype=torch.float32, device=state.device)
        return state.replace(scenario=scratch)

    def expected_knowledge(self, state: WorldState):
        return state.scenario[self._ekey()]

    def set_expected_knowledge(self, state: WorldState, knowledge, env_mask=None) -> WorldState:
        scratch = dict(state.scenario)
        knowledge = torch.as_tensor(knowledge, dtype=torch.float32, device=state.device)
        if env_mask is not None:
            knowledge = torch.where(env_mask[:, None], knowledge, scratch[self._ekey()])
        scratch[self._ekey()] = knowledge
        return state.replace(scenario=scratch)
