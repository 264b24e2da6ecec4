"""Holonomic dynamics: the decoded action is the force.

Counterpart of vmas_tpu/dynamics/holonomic.py.
"""

from vmas_tpu_torch.dynamics.common import Dynamics, scatter_force, stack_u


class Holonomic(Dynamics):
    @property
    def needed_action_size(self) -> int:
        return 2

    def process_action(self, world, state):
        return self.agent.set_force(state, self.agent.u(state)[:, :2])

    def batch_spec(self):
        return ("holonomic",)

    def batch_exact(self) -> bool:
        return True  # slice, stack and scatter only

    def process_action_batch(self, world, state, agents):
        return scatter_force(state, agents, stack_u(state, agents)[:, :, :2])
