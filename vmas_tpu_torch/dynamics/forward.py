"""Forward dynamics: the first action entry is a force along the agent's
heading.

Counterpart of vmas_tpu/dynamics/forward.py.
"""

import torch

from vmas_tpu_torch.core.utils import TorchUtils
from vmas_tpu_torch.dynamics.common import Dynamics, gather_body, scatter_force, stack_u


class Forward(Dynamics):
    @property
    def needed_action_size(self) -> int:
        return 1

    def process_action(self, world, state):
        u = self.agent.u(state)
        force_local = torch.stack([u[:, 0], torch.zeros_like(u[:, 0])], dim=-1)
        force = TorchUtils.rotate_vector(force_local, self.agent.rot(state))
        return self.agent.set_force(state, force)

    def batch_spec(self):
        return ("forward",)

    def process_action_batch(self, world, state, agents):
        u = stack_u(state, agents)  # [B, A, W]
        _, rot, _, _ = gather_body(state, agents)  # [B, A]
        force_local = torch.stack([u[:, :, 0], torch.zeros_like(u[:, :, 0])], dim=-1)
        return scatter_force(state, agents, TorchUtils.rotate_vector(force_local, rot))
