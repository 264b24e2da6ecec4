"""3D quadrotor dynamics projected onto the 2D world.

Counterpart of vmas_tpu/dynamics/drone.py. The hidden 12-dim state (roll,
pitch, yaw, body rates, world velocities, position) lives in
``state.dyn[agent.slot]`` as a ``[B, 12]`` tensor. The decoded action is
(thrust, three torques); the thrust is offset by the hover thrust. One
Euler or RK4 step of the 12-dim state advances it, and the force and
torque are what realise its planar change under the world's step
(divisions by ``dt**2`` as IEEE divisions, ``fused._div``). The drone
never groups (``batch_spec`` None): its hidden state is per agent.
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.core.fused import _div
from vmas_tpu_torch.dynamics.common import Dynamics


class Drone(Dynamics):
    def __init__(self, world, I_xx: float = 8.1e-3, I_yy: float = 8.1e-3, I_zz: float = 14.2e-3,
                 integration: str = "rk4"):
        super().__init__()
        if integration not in ("rk4", "euler"):
            raise ValueError(f"Integration method must be 'euler' or 'rk4', got {integration!r}")
        self.integration = integration
        self.I_xx = I_xx
        self.I_yy = I_yy
        self.I_zz = I_zz
        self.world = world
        self.g = 9.81
        self.dt = world.dt

    def init_state(self, batch_dim: int):
        # [phi, theta, psi, p, q, r, x_dot, y_dot, z_dot, x, y, z]
        device = self.world.device if self.world is not None else None
        return torch.zeros((batch_dim, 12), dtype=torch.float32, device=device)

    def f(self, state, thrust_command, torque_command):
        phi, theta, psi = state[:, 0], state[:, 1], state[:, 2]
        p, q, r = state[:, 3], state[:, 4], state[:, 5]
        x_dot, y_dot, z_dot = state[:, 6], state[:, 7], state[:, 8]

        c_phi, s_phi = torch.cos(phi), torch.sin(phi)
        c_theta, s_theta = torch.cos(theta), torch.sin(theta)
        c_psi, s_psi = torch.cos(psi), torch.sin(psi)

        m = self.agent.mass
        x_ddot = _div((c_phi * s_theta * c_psi + s_phi * s_psi) * thrust_command, m)
        y_ddot = _div((c_phi * s_theta * s_psi - s_phi * c_psi) * thrust_command, m)
        z_ddot = _div((c_phi * c_theta) * thrust_command, m) - self.g
        p_dot = _div(torque_command[:, 0] - (self.I_yy - self.I_zz) * q * r, self.I_xx)
        q_dot = _div(torque_command[:, 1] - (self.I_zz - self.I_xx) * p * r, self.I_yy)
        r_dot = _div(torque_command[:, 2] - (self.I_xx - self.I_yy) * p * q, self.I_zz)

        return torch.stack([p, q, r, p_dot, q_dot, r_dot, x_ddot, y_ddot, z_ddot, x_dot, y_dot, z_dot], dim=-1)

    def needs_reset(self, state) -> torch.Tensor:
        """``[B]`` bool: roll or pitch beyond +-30 degrees."""
        ds = self.agent.dyn_state(state)
        return torch.any(torch.abs(ds[:, :2]) > 30 * (math.pi / 180), dim=-1)

    def euler(self, state, thrust, torque):
        return self.dt * self.f(state, thrust, torque)

    def runge_kutta(self, state, thrust, torque):
        k1 = self.f(state, thrust, torque)
        k2 = self.f(state + self.dt * k1 / 2, thrust, torque)
        k3 = self.f(state + self.dt * k2 / 2, thrust, torque)
        k4 = self.f(state + self.dt * k3, thrust, torque)
        return (self.dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)

    @property
    def needed_action_size(self) -> int:
        return 4

    def process_action(self, world, state):
        agent = self.agent
        u = agent.u(state)
        thrust = u[:, 0] + agent.mass * self.g  # hover compensation
        torque = u[:, 1:4]

        ds = agent.dyn_state(state).clone()
        pos = agent.pos(state)
        ds[:, 9] = pos[:, 0]
        ds[:, 10] = pos[:, 1]
        ds[:, 2] = agent.rot(state)

        if self.integration == "euler":
            delta = self.euler(ds, thrust, torque)
        else:
            delta = self.runge_kutta(ds, thrust, torque)
        state = agent.set_dyn_state(state, ds + delta)

        vel = agent.vel(state)
        acc_x = _div(delta[:, 6] - vel[:, 0] * self.dt, self.dt**2)
        acc_y = _div(delta[:, 7] - vel[:, 1] * self.dt, self.dt**2)
        acc_ang = _div(delta[:, 5] - agent.ang_vel(state) * self.dt, self.dt**2)

        state = agent.set_force(state, torch.stack([acc_x, acc_y], dim=-1) * agent.mass)
        return agent.set_torque(state, agent.moment_of_inertia * acc_ang)
