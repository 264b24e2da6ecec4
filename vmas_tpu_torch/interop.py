"""State in and out of the port as numpy arrays.

``state_from_numpy(world, arrays)`` builds a :class:`WorldState` on
``world.device`` from a dict of numpy arrays; ``state_to_numpy(state)`` goes
the other way. The dict holds the fields ``pos``, ``vel``, ``rot``,
``ang_vel``, ``force``, ``torque``, ``c``, ``u`` (a sequence, one array per
agent), ``uc``, ``joint_fixed_rot`` and ``rendering``, and the ``scenario``
scratch dict. This is how a state made elsewhere (another simulator, a
recording, a test) is injected.
"""

from __future__ import annotations

import numpy as np
import torch

from vmas_tpu_torch.core.state import WorldState

FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque", "c", "uc", "joint_fixed_rot", "rendering")


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int64, device=device)
    return torch.tensor(a, dtype=torch.float32, device=device)


def state_from_numpy(world, arrays: dict) -> WorldState:
    dev = world.device
    base = world.spawn_state()
    kw = {f: _tensor(arrays[f], dev) if f in arrays else getattr(base, f) for f in FIELDS}
    u = arrays.get("u")
    kw["u"] = base.u if u is None else tuple(_tensor(x, dev) for x in u)
    kw["scenario"] = {k: _tensor(v, dev) for k, v in arrays.get("scenario", {}).items()}
    return base.replace(**kw)


def state_to_numpy(state: WorldState) -> dict:
    out = {f: getattr(state, f).detach().cpu().numpy() for f in FIELDS}
    out["u"] = [u.detach().cpu().numpy() for u in state.u]
    out["scenario"] = {
        k: v.detach().cpu().numpy() for k, v in state.scenario.items() if isinstance(v, torch.Tensor)
    }
    return out
