"""Differential-drive (unicycle) dynamics.

Counterpart of vmas_tpu/dynamics/diff_drive.py. The decoded action is
(forward speed, angular speed); one Euler or RK4 step of the unicycle gives
the pose change over ``dt``, and the force and torque are what realise it
under the world's semi-implicit Euler step, ``a = (delta - v dt) / dt^2``
(IEEE divisions on every device, ``fused._div``). ``process_action_batch``
is the same math on a ``[B, A]`` group.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.core.fused import _div
from vmas_tpu_torch.dynamics.common import (
    Dynamics, body_tensor, gather_body, scatter_force, scatter_torque, stack_u,
)


class DiffDrive(Dynamics):
    def __init__(self, world, integration: str = "rk4"):
        super().__init__()
        if integration not in ("rk4", "euler"):
            raise ValueError(f"Integration method must be 'euler' or 'rk4', got {integration!r}")
        self.dt = world.dt
        self.integration = integration
        self.world = world

    def f(self, state, u_command, ang_vel_command):
        theta = state[..., 2]
        dx = u_command * torch.cos(theta)
        dy = u_command * torch.sin(theta)
        return torch.stack((dx, dy, ang_vel_command), dim=-1)

    def euler(self, state, u_command, ang_vel_command):
        return self.dt * self.f(state, u_command, ang_vel_command)

    def runge_kutta(self, state, u_command, ang_vel_command):
        k1 = self.f(state, u_command, ang_vel_command)
        k2 = self.f(state + self.dt * k1 / 2, u_command, ang_vel_command)
        k3 = self.f(state + self.dt * k2 / 2, u_command, ang_vel_command)
        k4 = self.f(state + self.dt * k3, u_command, ang_vel_command)
        return (self.dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)

    def _delta(self, pos, rot, u):
        cur = torch.cat([pos, rot[..., None]], dim=-1)
        if self.integration == "euler":
            return self.euler(cur, u[..., 0], u[..., 1])
        return self.runge_kutta(cur, u[..., 0], u[..., 1])

    @property
    def needed_action_size(self) -> int:
        return 2

    def process_action(self, world, state):
        agent = self.agent
        delta = self._delta(agent.pos(state), agent.rot(state), agent.u(state))
        acc_xy = _div(delta[:, :2] - agent.vel(state) * self.dt, self.dt**2)
        acc_ang = _div(delta[:, 2] - agent.ang_vel(state) * self.dt, self.dt**2)
        state = agent.set_force(state, agent.mass * acc_xy)
        return agent.set_torque(state, agent.moment_of_inertia * acc_ang)

    def batch_spec(self):
        return ("diff_drive", self.dt, self.integration)

    def process_action_batch(self, world, state, agents):
        pos, rot, vel, ang_vel = gather_body(state, agents)
        delta = self._delta(pos, rot, stack_u(state, agents))
        acc_xy = _div(delta[..., :2] - vel * self.dt, self.dt**2)
        acc_ang = _div(delta[..., 2] - ang_vel * self.dt, self.dt**2)
        mass = body_tensor(agents, "mass", state.device)
        moi = body_tensor(agents, "moment_of_inertia", state.device)
        state = scatter_force(state, agents, mass[None, :, None] * acc_xy)
        return scatter_torque(state, agents, moi[None] * acc_ang)
