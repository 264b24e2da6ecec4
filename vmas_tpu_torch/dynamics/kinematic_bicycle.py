"""Kinematic bicycle model (Polack et al. 2017, eq. 2).

Counterpart of vmas_tpu/dynamics/kinematic_bicycle.py. The decoded action
is (speed, steering angle); one Euler or RK4 step of the bicycle gives the
pose change over ``dt``, and the force and torque are what carry the body
there in one physics step. The divisions by ``dt**2`` are IEEE divisions
(``fused._div``) on every device. ``process_action_batch`` is the same
math on a ``[B, A]`` group.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.core.fused import _div
from vmas_tpu_torch.dynamics.common import (
    Dynamics, body_tensor, gather_body, scatter_force, scatter_torque, stack_u,
)


class KinematicBicycle(Dynamics):
    def __init__(self, world, width: float, l_f: float, l_r: float, max_steering_angle: float,
                 integration: str = "rk4"):
        super().__init__()
        if integration not in ("rk4", "euler"):
            raise ValueError(f"Integration method must be 'euler' or 'rk4', got {integration!r}")
        self.width = width
        self.l_f = l_f
        self.l_r = l_r
        self.max_steering_angle = max_steering_angle
        self.dt = world.dt
        self.integration = integration

    def f(self, state, steering_command, v_command):
        theta = state[..., 2]
        tan_s = torch.tan(steering_command)
        beta = torch.atan2(tan_s * self.l_r / (self.l_f + self.l_r), torch.ones_like(tan_s))
        dx = v_command * torch.cos(theta + beta)
        dy = v_command * torch.sin(theta + beta)
        dtheta = v_command / (self.l_f + self.l_r) * torch.cos(beta) * tan_s
        return torch.stack((dx, dy, dtheta), dim=-1)

    def euler(self, state, steering_command, v_command):
        return self.dt * self.f(state, steering_command, v_command)

    def runge_kutta(self, state, steering_command, v_command):
        k1 = self.f(state, steering_command, v_command)
        k2 = self.f(state + self.dt * k1 / 2, steering_command, v_command)
        k3 = self.f(state + self.dt * k2 / 2, steering_command, v_command)
        k4 = self.f(state + self.dt * k3, steering_command, v_command)
        return (self.dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)

    def _delta(self, pos, rot, u):
        """The pose change over ``dt`` from pose ``(pos, rot)`` under the
        decoded actions ``u`` (any leading axes)."""
        v_command = u[..., 0]
        steering_command = torch.clamp(u[..., 1], -self.max_steering_angle, self.max_steering_angle)
        cur = torch.cat([pos, rot[..., None]], dim=-1)
        if self.integration == "euler":
            return self.euler(cur, steering_command, v_command)
        return self.runge_kutta(cur, steering_command, v_command)

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
        return ("kinematic_bicycle", self.width, self.l_f, self.l_r, self.max_steering_angle, self.dt,
                self.integration)

    def process_action_batch(self, world, state, agents):
        pos, rot, vel, ang_vel = gather_body(state, agents)
        delta = self._delta(pos, rot, stack_u(state, agents))
        acc_xy = _div(delta[..., :2] - vel * self.dt, self.dt**2)
        acc_ang = _div(delta[..., 2] - ang_vel * self.dt, self.dt**2)
        mass = body_tensor(agents, "mass", state.device)
        moi = body_tensor(agents, "moment_of_inertia", state.device)
        state = scatter_force(state, agents, mass[None, :, None] * acc_xy)
        return scatter_torque(state, agents, moi[None] * acc_ang)
