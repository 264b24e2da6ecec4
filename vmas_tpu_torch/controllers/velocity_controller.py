"""Vectorized PID velocity controller.

Counterpart of vmas_tpu/controllers/velocity_controller.py. The
controller's integrator and derivative memory lives in the scenario scratch
under ``state.scenario[self.key]`` (``{"accum_errs", "prev_err"}``, each
``[B, 2]``), set by :meth:`reset` in the scenario's ``reset_world_at``
(partial resets go through the environment's masked blend). Its rows form
for the fused kernel (``rows_step``) is not ported yet.
"""

from __future__ import annotations

import math
import warnings

import torch

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

        d_term = self.derivativeTs * (err - prev) / self.dt
        prev = err

        u = self.ctrl_gain * (err + i_term + d_term) * self.agent.mass
        scratch = dict(state.scenario)
        scratch[self.key] = {"accum_errs": accum, "prev_err": prev}
        state = state.replace(scenario=scratch)
        return self.agent.set_u(state, u)
