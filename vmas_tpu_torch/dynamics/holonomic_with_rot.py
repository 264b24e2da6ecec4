"""Holonomic dynamics with rotation: force from the first two action
entries, torque from the third.

Counterpart of vmas_tpu/dynamics/holonomic_with_rot.py.
"""

from vmas_tpu_torch.dynamics.common import Dynamics


class HolonomicWithRotation(Dynamics):
    @property
    def needed_action_size(self) -> int:
        return 3

    def process_action(self, world, state):
        u = self.agent.u(state)
        state = self.agent.set_force(state, u[:, :2])
        return self.agent.set_torque(state, u[:, 2])
