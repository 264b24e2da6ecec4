"""Vectorized PID velocity controller.

Counterpart of vmas_tpu/controllers/velocity_controller.py. The
controller's integrator and derivative memory lives in the scenario scratch
under ``state.scenario[self.key]`` (``{"accum_errs", "prev_err"}``, each
``[B, 2]``), set by :meth:`reset` in the scenario's ``reset_world_at``
(partial resets go through the environment's masked blend). ``rows_step``
is the same update on ``[B]`` rows, the plain version of the PID that the
fused kernel runs in its rows form (``core/fused.py`` ``PidActRows``).

The division by ``dt`` is one IEEE division in both forms (a tensor divided
by a 0-dim tensor): PyTorch turns ``cuda_tensor / python_float`` into a
multiplication by the reciprocal, which the kernel does not do.
"""

from __future__ import annotations

import math
import warnings

import torch

from vmas_tpu_torch.core.fused import _div
from vmas_tpu_torch.core.state import WorldState


class VelocityController:
    def __init__(self, agent, world, ctrl_params=(1, 0, 0), pid_form="standard"):
        self.agent = agent
        self.world = world
        self.dt = world.dt
        self.key = f"__vel_ctrl_{agent.name}"
        self.ctrl_gain = ctrl_params[0]
        if pid_form == "standard":
            self.integralTs = ctrl_params[1]
            self.derivativeTs = ctrl_params[2]
        elif pid_form == "parallel":
            self.integralTs = 0.0 if ctrl_params[1] == 0 else self.ctrl_gain / ctrl_params[1]
            self.derivativeTs = ctrl_params[2] / self.ctrl_gain
        else:
            raise Exception("PID form is either standard or parallel.")

        self.use_integrator = self.integralTs != 0
        self.integrator_windup_cutoff = None
        if self.use_integrator:
            fmax = min(self.agent.max_f, self.agent.f_range, key=lambda x: x if x is not None else math.inf)
            if fmax is not None:
                self.integrator_windup_cutoff = 0.5 * fmax * self.integralTs / (self.dt * self.ctrl_gain)
            else:
                warnings.warn("Force limits not specified. Integrator can wind up!")

    def reset(self, state: WorldState, env_mask=None) -> WorldState:
        """Zero the PID memory; with ``env_mask`` ([B] bool) only the masked
        envs."""
        B, dev = state.batch_dim, state.device
        zeros = {
            "accum_errs": torch.zeros((B, 2), dtype=torch.float32, device=dev),
            "prev_err": torch.zeros((B, 2), dtype=torch.float32, device=dev),
        }
        scratch = dict(state.scenario)
        if env_mask is not None and self.key in scratch:
            old = scratch[self.key]
            m = env_mask[:, None]
            zeros = {k: torch.where(m, zeros[k], old[k]) for k in zeros}
        scratch[self.key] = zeros
        return state.replace(scenario=scratch)

    def rows_params(self):
        """The constants of the update as the JAX package computes them, in
        double precision and rounded to f32 where they meet a row:
        ``(dt, gain, mass, use_integrator, inv_ti, cutoff or None, td)``."""
        use_i = bool(self.use_integrator)
        cutoff = self.integrator_windup_cutoff
        return (
            float(self.dt), float(self.ctrl_gain), float(self.agent.mass), use_i,
            float(1.0 / self.integralTs) if use_i else 0.0,
            None if cutoff is None else float(cutoff), float(self.derivativeTs),
        )

    def rows_step(self):
        """The update on ``[B]`` rows: ``step(ux, uy, vx, vy, acx, acy, prx,
        pry, reset_mask) -> (fx, fy, acx', acy', prx', pry')``, the ops of
        :meth:`reset`'s masked zeroing and then :meth:`process_force`, in
        their order."""
        dt, gain, mass, use_i, inv_ti, cutoff, td = self.rows_params()

        def step(ux, uy, vx, vy, acx, acy, prx, pry, reset_mask):
            if reset_mask is not None:
                acx = torch.where(reset_mask, 0.0, acx)
                acy = torch.where(reset_mask, 0.0, acy)
                prx = torch.where(reset_mask, 0.0, prx)
                pry = torch.where(reset_mask, 0.0, pry)
            ex, ey = ux - vx, uy - vy
            if use_i:
                acx = acx + dt * ex
                acy = acy + dt * ey
                if cutoff is not None:
                    acx = torch.clamp(acx, -cutoff, cutoff)
                    acy = torch.clamp(acy, -cutoff, cutoff)
                i_x, i_y = inv_ti * acx, inv_ti * acy
            else:
                i_x = i_y = 0.0
            d_x = _div(td * (ex - prx), dt)
            d_y = _div(td * (ey - pry), dt)
            fx = gain * (ex + i_x + d_x) * mass
            fy = gain * (ey + i_y + d_y) * mass
            return fx, fy, acx, acy, ex, ey

        return step

    def process_force(self, state: WorldState) -> WorldState:
        """The agent's u, read as a desired velocity, becomes the force the
        PID law asks for; the memory advances."""
        cs = state.scenario[self.key]
        accum, prev = cs["accum_errs"], cs["prev_err"]

        err = self.agent.u(state) - self.agent.vel(state)
        if self.use_integrator:
            accum = accum + self.dt * err
            if self.integrator_windup_cutoff is not None:
                accum = torch.clamp(accum, -self.integrator_windup_cutoff, self.integrator_windup_cutoff)
            i_term = (1.0 / self.integralTs) * accum
        else:
            i_term = 0.0

        d_term = _div(self.derivativeTs * (err - prev), self.dt)
        prev = err

        u = self.ctrl_gain * (err + i_term + d_term) * self.agent.mass
        scratch = dict(state.scenario)
        scratch[self.key] = {"accum_errs": accum, "prev_err": prev}
        state = state.replace(scenario=scratch)
        return self.agent.set_u(state, u)
