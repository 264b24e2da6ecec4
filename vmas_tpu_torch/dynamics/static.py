"""Static dynamics: the agent's actions move nothing.

Counterpart of vmas_tpu/dynamics/static.py.
"""

from vmas_tpu_torch.dynamics.common import Dynamics


class Static(Dynamics):
    @property
    def needed_action_size(self) -> int:
        return 0

    def process_action(self, world, state):
        return state

    def batch_spec(self):
        return ("static",)

    def batch_exact(self) -> bool:
        return True

    def process_action_batch(self, world, state, agents):
        return state
