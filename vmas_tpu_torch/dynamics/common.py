"""Dynamics base class and the agent-group helpers.

Counterpart of vmas_tpu/dynamics/common.py. ``process_action`` is
functional: it reads the agent's decoded action from ``state.u`` and
returns a new state with the agent's ``state.force``/``state.torque`` rows
written. Stateful models (Drone) keep their hidden state in ``state.dyn``.

Models whose ``process_action`` is elementwise in the agent axis advertise
a ``batch_spec`` key; the environment groups same-key agents when it is
built and runs one ``[B, A]`` ``process_action_batch`` per group
(``Environment._plan_process_action``). ``batch_exact`` models (the
holonomic family, static, rotation) only move data, so the grouped form is
bitwise the per-agent loop and they group by default; the others compute
``sin``/``cos``/``tan`` on the stacked shape, which PyTorch's vectorized
and scalar CPU paths may round an ulp apart, so they group only under
``VMAS_TPU_BATCH_DYNAMICS=1``.
"""

from __future__ import annotations

import abc
from abc import ABC

import torch


def _index(agents, device):
    return torch.as_tensor([a.index for a in agents], dtype=torch.long, device=device)


def stack_u(state, agents):
    """``[B, A, W]`` stack of the group's decoded actions (equal widths: the
    grouping key includes ``action_size``)."""
    return torch.stack([a.u(state) for a in agents], dim=1)


def gather_body(state, agents):
    """``(pos [B, A, 2], rot [B, A], vel [B, A, 2], ang_vel [B, A])`` of the
    group."""
    idx = _index(agents, state.device)
    return state.pos[:, idx], state.rot[:, idx], state.vel[:, idx], state.ang_vel[:, idx]


def scatter_force(state, agents, force):
    """``force [B, A, 2]`` written to the group's entity rows: the grouped
    form of per-agent ``set_force`` (the same values, disjoint rows)."""
    out = state.force.clone()
    out[:, _index(agents, state.device)] = torch.as_tensor(force, dtype=torch.float32, device=state.device)
    return state.replace(force=out)


def scatter_torque(state, agents, torque):
    out = state.torque.clone()
    out[:, _index(agents, state.device)] = torch.as_tensor(torque, dtype=torch.float32, device=state.device)
    return state.replace(torque=out)


def body_tensor(agents, attr, device):
    """``[A]`` f32 tensor of each agent's ``attr`` (mass, moment of
    inertia), as the JAX package builds it with numpy."""
    return torch.as_tensor([float(getattr(a, attr)) for a in agents], dtype=torch.float32, device=device)


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

    def batch_spec(self):
        """Hashable grouping key, or None where the model runs per agent
        (stateful models such as Drone)."""
        return None

    def batch_exact(self) -> bool:
        """True where ``process_action_batch`` is bitwise the per-agent loop
        (it only slices, stacks and scatters)."""
        return False

    def process_action_batch(self, world, state, agents):
        """Process a same-``batch_spec`` group in one ``[B, A]``
        computation; called only where ``batch_spec()`` is not None."""
        raise NotImplementedError

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
