"""Runtime validation helpers (counterpart of vmas_tpu/debug.py).

The JAX package wraps its step in checkify: float checks at every primitive
(NaN production) and explicit finiteness invariants on the step's outputs.
Here the step runs eagerly, so the counterpart of checkify's float checks
is a ``TorchDispatchMode`` around the step: for each aten op that computes
a floating tensor it records, on the device, whether the op produced a NaN
from NaN-free inputs. The host reads every flag once, after the step, so
the step is not synchronised op by op; a raised error names the first op
that produced one.

Usage::

    from vmas_tpu_torch.debug import checked_step

    step = checked_step(env)
    obs, rews, dones, infos = step(actions)   # raises on NaN / bad outputs

Scope: the op watch sees aten ops only. The fused kernel is launched
through ctypes, not as an aten op, so a NaN it makes is caught by the
output invariants (the post-step state, observations and rewards must be
finite), which also catch Inf (an overflow makes no NaN). Ops that only
allocate (``torch.empty`` and its kin, whose memory is uninitialised) are
not watched. A NaN or Inf confined to intermediate values that an op
masks away again is flagged where it is made as NaN, and not at all as
Inf. The watch costs a few device operations per op and the check one
host read per step: a tool for debugging new scenarios and kernels, not
for production rollouts.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vmas_tpu_torch.core.utils import tree_leaves

__all__ = ["checked_step", "validate_state"]

_aten = torch.ops.aten
# ops that allocate without computing: their output is uninitialised memory
_ALLOCATING = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
    _aten.resize_, _aten.set_,
}


def _floats(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _any_nan(tensors):
    # the flags of tensors on several devices (a CPU scalar beside CUDA
    # tensors) combine by a logical or, which accepts a CPU 0-d operand
    return functools.reduce(torch.logical_or, (t.isnan().any() for t in tensors))


class _NanWatch(TorchDispatchMode):
    """Records, per aten op that computes floating outputs, a device flag:
    a NaN in the outputs and none in the inputs. Inside
    ``__torch_dispatch__`` the mode is off, so its own ops are not
    watched."""

    def __init__(self):
        super().__init__()
        self.ops, self.flags = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in _ALLOCATING:
            return func(*args, **kwargs)
        ins = _floats((args, kwargs))
        # read before the op runs: an in-place op overwrites its input
        nan_in = _any_nan(ins) if ins else None
        out = func(*args, **kwargs)
        outs = _floats(out)
        if outs:
            nan_out = _any_nan(outs)
            self.flags.append(nan_out if nan_in is None else nan_out & ~nan_in)
            self.ops.append(str(func))
        return out


def _state_flags(state):
    """(message, device flag of a violation) for each invariant of a
    WorldState: finite positions, velocities, rotations and angular
    velocities."""
    return [
        ("non-finite entity positions", ~torch.isfinite(state.pos).all()),
        ("non-finite entity velocities", ~torch.isfinite(state.vel).all()),
        ("non-finite rotations", ~torch.isfinite(state.rot).all()),
        ("non-finite angular velocities", ~torch.isfinite(state.ang_vel).all()),
    ]


def _tree_flag(message, tree):
    leaves = _floats(tree)
    flag = functools.reduce(torch.logical_or, (~torch.isfinite(t).all() for t in leaves)) if leaves else None
    return [] if flag is None else [(message, flag)]


def _raise_on(checks, watch=None):
    """Read every flag in one host copy; raise FloatingPointError naming the
    violated invariants and the first op that made a NaN."""
    flags = [f for _, f in checks] + (watch.flags if watch is not None else [])
    if not flags:
        return
    dev = flags[0].device
    host = torch.stack([f.to(dev) for f in flags]).cpu().tolist()
    bad = [m for (m, _), b in zip(checks, host) if b]
    if watch is not None:
        made = [i for i, b in enumerate(host[len(checks):]) if b]
        if made:
            bad.insert(0, f"nan first produced by {watch.ops[made[0]]} (op {made[0] + 1} of "
                          f"{len(watch.ops)} watched in the step; {len(made)} ops made a nan)")
    if bad:
        raise FloatingPointError("; ".join(bad))


def validate_state(state) -> None:
    """Raise ``FloatingPointError`` if a WorldState's positions, velocities,
    rotations or angular velocities are not all finite (one host read)."""
    _raise_on(_state_flags(state))


def checked_step(env):
    """A drop-in replacement for ``env.step`` that raises
    ``FloatingPointError`` on NaN production in any aten op of the step and
    on non-finite values reaching the post-step state, observations or
    rewards (explicit invariants). It runs the env's own ``_step_fn_raw``
    with the env's generator, so its draws and results are bitwise
    ``env.step``'s; on a raise the env keeps its pre-step state (its
    generator has advanced, as the JAX package's key has)."""

    def step(actions):
        actions = env._normalize_actions(actions)
        watch = _NanWatch()
        with watch:
            out = env._step_fn_raw(env.state, env.steps, actions, env.generator)
        state, obs, rews, terminated, truncated, infos, steps = out
        _raise_on(_state_flags(state) + _tree_flag("non-finite observations", obs)
                  + _tree_flag("non-finite rewards", rews), watch)
        env.state, env.steps = state, steps
        return env._pack_result(obs, rews, terminated, truncated, infos, True, True, True, True)

    return step
