"""Holonomic dynamics: the decoded action is the force."""

from vmas_tpu_torch.dynamics.common import Dynamics


class Holonomic(Dynamics):
    @property
    def needed_action_size(self) -> int:
        return 2

    def process_action(self, world, state):
        return self.agent.set_force(state, self.agent.u(state)[:, :2])
