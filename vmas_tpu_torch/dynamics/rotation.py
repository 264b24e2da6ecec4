"""Rotation dynamics: the first action entry is the torque.

Counterpart of vmas_tpu/dynamics/rotation.py.
"""

from vmas_tpu_torch.dynamics.common import Dynamics, scatter_torque, stack_u


class Rotation(Dynamics):
    @property
    def needed_action_size(self) -> int:
        return 1

    def process_action(self, world, state):
        return self.agent.set_torque(state, self.agent.u(state)[:, 0])

    def batch_spec(self):
        return ("rotation",)

    def batch_exact(self) -> bool:
        return True  # slice, stack and scatter only

    def process_action_batch(self, world, state, agents):
        return scatter_torque(state, agents, stack_u(state, agents)[:, :, 0])
