"""State in and out of the port as numpy arrays.

``state_from_numpy(world, arrays)`` builds a :class:`WorldState` on
``world.device`` from a dict of numpy arrays; ``state_to_numpy(state)`` goes
the other way. The dict holds the fields ``pos``, ``vel``, ``rot``,
``ang_vel``, ``force``, ``torque``, ``c``, ``u`` (a sequence, one array per
agent), ``uc``, ``joint_fixed_rot``, ``rendering`` and, in a world with
dynamic gravity, ``dyn_gravity``, and the ``scenario`` scratch dict, whose
values are arrays or dicts of them (a velocity controller's memory,
``{"accum_errs", "prev_err"}``; football's team AI, ``ai_Red`` /
``ai_Blue``). This is how a state made elsewhere (another simulator, a
recording, a test) is injected. A scratch entry named in ``KEY_SCRATCH``
(the JAX package's PRNG keys: discovery's respawn key ``rng``, and the
step's observation key ``__obs_key``, from which its football AI draws) is
left behind: the port draws from the environment's generator at each
step.

``actor_critic_from_numpy(params)`` builds the PPO actor-critic
(``parallel.ppo.ActorCritic``) from the JAX package's ``init_actor_critic``
pytree as numpy arrays, ``{"pi": [{"w", "b"}, ...], "v": [...],
"log_std"}`` with each ``w`` ``[in, out]``; ``actor_critic_to_numpy(model)``
goes the other way, bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from vmas_tpu_torch.core.state import WorldState

FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque", "c", "uc", "joint_fixed_rot", "rendering")
# scratch entries that hold another package's random key, not state
KEY_SCRATCH = ("rng", "__obs_key")


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
    kw["scenario"] = _scratch_in({k: v for k, v in arrays.get("scenario", {}).items() if k not in KEY_SCRATCH}, dev)
    if base.dyn_gravity is not None and "dyn_gravity" in arrays:
        kw["dyn_gravity"] = _tensor(arrays["dyn_gravity"], dev)
    return base.replace(**kw)


def _scratch_in(d, device):
    return {k: _scratch_in(v, device) if isinstance(v, dict) else _tensor(v, device) for k, v in d.items()}


def _scratch_out(d):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _scratch_out(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
    return out


def state_to_numpy(state: WorldState) -> dict:
    out = {f: getattr(state, f).detach().cpu().numpy() for f in FIELDS}
    out["u"] = [u.detach().cpu().numpy() for u in state.u]
    out["scenario"] = _scratch_out(state.scenario)
    if state.dyn_gravity is not None:
        out["dyn_gravity"] = state.dyn_gravity.detach().cpu().numpy()
    return out


def actor_critic_from_numpy(params: dict, device=None):
    """The PPO actor-critic with the weights of ``params`` (``w`` is ``[in,
    out]``, ``nn.Linear.weight`` its transpose), on the GPU unless
    ``device`` says otherwise."""
    from vmas_tpu_torch.core.utils import resolve_device
    from vmas_tpu_torch.parallel.ppo import ActorCritic

    device = resolve_device(device)
    pi, v = params["pi"], params["v"]
    hidden = tuple(np.shape(layer["w"])[1] for layer in pi[:-1])
    model = ActorCritic(np.shape(pi[0]["w"])[0], np.shape(pi[-1]["w"])[1], hidden, device=device)
    with torch.no_grad():
        for layers, src in ((model.pi, pi), (model.v, v)):
            for layer, p in zip(layers, src):
                layer.weight.copy_(torch.tensor(np.asarray(p["w"], np.float32).T))
                layer.bias.copy_(torch.tensor(np.asarray(p["b"], np.float32)))
        model.log_std.copy_(torch.tensor(np.asarray(params["log_std"], np.float32)))
    return model


def actor_critic_to_numpy(model) -> dict:
    def trunk(layers):
        return [
            {"w": layer.weight.detach().cpu().numpy().T.copy(), "b": layer.bias.detach().cpu().numpy().copy()}
            for layer in layers
        ]

    return {"pi": trunk(model.pi), "v": trunk(model.v), "log_std": model.log_std.detach().cpu().numpy().copy()}
