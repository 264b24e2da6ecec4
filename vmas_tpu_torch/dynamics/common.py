"""Dynamics base class.

Counterpart of vmas_tpu/dynamics/common.py. ``process_action`` is
functional: it reads the agent's decoded action from ``state.u`` and
returns a new state with the agent's ``state.force``/``state.torque`` rows
written. The grouped ``[B, A]`` form of the JAX package is not ported:
agents are processed one by one.
"""

from __future__ import annotations

import abc
from abc import ABC


class Dynamics(ABC):
    def __init__(self):
        self._agent = None
        self.world = None  # set by World.add_agent

    @property
    def agent(self):
        if self._agent is None:
            raise ValueError(
                "You need to add the dynamics to an agent during construction before accessing its properties"
            )
        return self._agent

    @agent.setter
    def agent(self, value):
        if self._agent is not None:
            raise ValueError("Agent in dynamics has already been set")
        self._agent = value

    def init_state(self, batch_dim: int):
        """Hidden dynamics state of a fresh env (none by default)."""
        return ()

    def check_and_process_action(self, world, state):
        u = self.agent.u(state)
        if u.shape[1] < self.needed_action_size:
            raise ValueError(
                f"Agent action size {u.shape[1]} is less than the required "
                f"dynamics action size {self.needed_action_size}"
            )
        return self.process_action(world, state)

    @property
    @abc.abstractmethod
    def needed_action_size(self) -> int: ...

    @abc.abstractmethod
    def process_action(self, world, state): ...
