"""State in and out of the port as numpy arrays.

``state_from_numpy(world, arrays)`` builds a :class:`WorldState` on
``world.device`` from a dict of numpy arrays; ``state_to_numpy(state)`` goes
the other way. The dict holds the fields ``pos``, ``vel``, ``rot``,
``ang_vel``, ``force``, ``torque``, ``c``, ``u`` (a sequence, one array per
agent), ``uc``, ``joint_fixed_rot``, ``rendering`` and, in a world with
dynamic gravity, ``dyn_gravity``; in a world whose dynamics keep a hidden
state (the drone's ``[B, 12]``), ``dyn``, a sequence of one array per agent
or ``()`` where its model keeps none (a world without hidden state has no
``dyn`` entry); and the ``scenario`` scratch dict, whose
values are arrays or dicts of them (a velocity controller's memory,
``{"accum_errs", "prev_err"}``; football's team AI, ``ai_Red`` /
``ai_Blue``). This is how a state made elsewhere (another simulator, a
recording, a test) is injected. A scratch entry named in ``KEY_SCRATCH``
(the JAX package's PRNG keys: discovery's respawn key ``rng``, and the
step's observation key ``__obs_key``, from which its football AI draws) is
left behind: the port draws from the environment's generator at each
step.

``state_to_tensors(state)`` is the same dict with the state's own
(detached) tensors in place of the numpy arrays, and ``state_onto(template,
arrays)`` the template's state with every leaf of that dict replaced by the
array of the same name, cast to the template leaf's dtype and device
(``checkpoint`` restores states so, after checking each leaf's name and
shape).

``actor_critic_from_numpy(params)`` builds the PPO actor-critic
(``parallel.ppo.ActorCritic``) from the JAX package's ``init_actor_critic``
pytree as numpy arrays, ``{"pi": [{"w", "b"}, ...], "v": [...],
"log_std"}`` with each ``w`` ``[in, out]``; ``actor_critic_to_numpy(model)``
goes the other way, bitwise. ``learner_params_from_numpy(params)`` and
``learner_params_to_numpy(params)`` do the same for the MLP of
``parallel.learner`` (the JAX package's ``init_mlp`` pytree, ``[{"w": [in,
out], "b": [out]}, ...]``), whose port keeps that layout.
"""

from __future__ import annotations

import numpy as np
import torch

from vmas_tpu_torch.core.state import WorldState
from vmas_tpu_torch.core.utils import tree_map

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
    if "dyn" in arrays:
        kw["dyn"] = tuple(() if _empty(x) else _tensor(x, dev) for x in arrays["dyn"])
    return base.replace(**kw)


def _empty(x):
    return isinstance(x, (tuple, list)) and not x


def _scratch_in(d, device):
    return {k: _scratch_in(v, device) if isinstance(v, dict) else _tensor(v, device) for k, v in d.items()}


def _scratch_out(d):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _scratch_out(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach()
    return out


def state_to_tensors(state: WorldState) -> dict:
    """``state_to_numpy``'s dict with the state's detached tensors as its
    leaves (no copy)."""
    out = {f: getattr(state, f).detach() for f in FIELDS}
    out["u"] = [u.detach() for u in state.u]
    out["scenario"] = _scratch_out(state.scenario)
    if state.dyn_gravity is not None:
        out["dyn_gravity"] = state.dyn_gravity.detach()
    if any(isinstance(d, torch.Tensor) for d in state.dyn):
        out["dyn"] = [d.detach() if isinstance(d, torch.Tensor) else () for d in state.dyn]
    return out


def state_to_numpy(state: WorldState) -> dict:
    return tree_map(lambda t: t.cpu().numpy(), state_to_tensors(state))


def state_onto(template: WorldState, arrays: dict) -> WorldState:
    """``template`` with each leaf of ``state_to_tensors(template)`` replaced
    by the array of the same name in ``arrays`` (that dict's nesting), cast
    to the template leaf's dtype and put on its device. The caller checks
    the names and shapes (``checkpoint`` does, naming the leaf that
    differs)."""

    def onto(t, a):
        if isinstance(t, dict):
            return {k: onto(t[k], a[k]) for k in t}
        if isinstance(t, list):
            return [onto(x, y) for x, y in zip(t, a)]
        if not isinstance(t, torch.Tensor):
            return t
        return torch.as_tensor(a).to(device=t.device, dtype=t.dtype)

    got = onto(state_to_tensors(template), arrays)
    kw = {f: got[f] for f in FIELDS}
    kw["u"] = tuple(got["u"])
    kw["scenario"] = _merge_scratch(template.scenario, got["scenario"])
    if "dyn_gravity" in got:
        kw["dyn_gravity"] = got["dyn_gravity"]
    if "dyn" in got:
        kw["dyn"] = tuple(() if _empty(x) else x for x in got["dyn"])
    return template.replace(**kw)


def _merge_scratch(template, got):
    """The scratch dict ``template`` with its tensors (and dicts of them)
    taken from ``got``; its other values kept."""
    return {k: (_merge_scratch(v, got[k]) if isinstance(v, dict) else got[k] if k in got else v)
            for k, v in template.items()}


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


def learner_params_from_numpy(params, device=None):
    """``parallel.learner``'s MLP parameters from the JAX package's
    ``init_mlp`` pytree as numpy arrays (``[{"w": [in, out], "b": [out]},
    ...]``, the same layout), as float32 tensors on the GPU unless
    ``device`` says otherwise."""
    from vmas_tpu_torch.core.utils import resolve_device

    device = resolve_device(device)
    return [{k: torch.tensor(np.asarray(layer[k], np.float32), device=device) for k in ("w", "b")}
            for layer in params]


def learner_params_to_numpy(params):
    return [{k: layer[k].detach().cpu().numpy().copy() for k in ("w", "b")} for layer in params]
