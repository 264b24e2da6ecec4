"""Checkpoint and resume for environment state (counterpart of
vmas_tpu/checkpoint.py).

An Environment's mutable state is its ``WorldState``, its step counters,
its ``torch.Generator`` and the last observation seed drawn from it
(``BaseScenario.obs_seed``); the generator's state stands in for the JAX
package's PRNG key. So a snapshot restores exactly: a resumed env replays
the same random actions, noise and resets bitwise.

Leaves are keyed by name, not by flatten order: a ``WorldState`` is
written through ``interop.state_to_numpy``'s schema (``state/pos``,
``state/u/0``, ``state/dyn/1``, ``state/scenario/<key>/...``), so the
dynamics' hidden state and the scenario scratch come along, and a leaf
missing on either side or of another shape raises ``ValueError`` naming it.
Leaves are restored onto the template's device and in its dtypes;
zero-size leaves (``c[B, A, 0]`` where ``dim_c == 0``) keep their shape.

Two backends:

* ``npz`` (the default): one host-local ``.npz`` file
  (``save_state``/``load_state``);
* ``dcp``: ``torch.distributed.checkpoint``, a directory of shards, which
  runs with or without a process group (``save_state_dcp``/
  ``load_state_dcp``). It takes the place of the JAX package's orbax
  backend.

On an env sharded over a mesh of more than one rank (``parallel.distribute``)
each rank saves and restores its own shard: the npz file gets the rank in
its name (``ckpt.rank1.npz``), and the dcp keys carry it (``rank1/state/pos``).
"""

from __future__ import annotations

import os
import warnings
from typing import Any

import numpy as np
import torch

from vmas_tpu_torch import interop
from vmas_tpu_torch.core.state import WorldState

__all__ = [
    "save_env", "load_env", "save_state", "load_state",
    "save_state_dcp", "load_state_dcp",
]


def _flatten(tree, name="", out=None) -> dict:
    """The leaves of ``tree`` (dicts, lists, tuples, a ``WorldState``, tensors
    and numpy arrays) by their ``/``-joined names."""
    out = {} if out is None else out
    join = (lambda k: f"{name}/{k}") if name else str
    if isinstance(tree, WorldState):
        tree = interop.state_to_tensors(tree)
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, join(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, join(i), out)
    elif isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        out[name] = tree
    return out


def _restore(template, arrays, name=""):
    """``template`` with each leaf replaced by ``arrays[name]``, cast to the
    leaf's dtype (and for tensors put on its device)."""
    join = (lambda k: f"{name}/{k}") if name else str
    if isinstance(template, WorldState):
        nested = _restore(interop.state_to_tensors(template), arrays, name)
        return interop.state_onto(template, nested)
    if isinstance(template, dict):
        return {k: _restore(v, arrays, join(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(v, arrays, join(i)) for i, v in enumerate(template))
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arrays[name]).to(device=template.device, dtype=template.dtype)
    if isinstance(template, (np.ndarray, np.generic)):
        return np.asarray(arrays[name], dtype=template.dtype)
    return template


def _check(want: dict, shapes: dict, where: str) -> None:
    """Every leaf of the template is in the checkpoint with its shape, and
    the checkpoint holds no other."""
    missing = sorted(set(want) - set(shapes))
    extra = sorted(set(shapes) - set(want))
    if missing or extra:
        leaf = missing[0] if missing else extra[0]
        raise ValueError(
            f"{where}: leaf {leaf!r} is {'missing from the checkpoint' if missing else 'not in the template'} "
            f"({len(missing)} missing, {len(extra)} extra; the scenario config must match the one checkpointed)")
    for k, leaf in want.items():
        if tuple(shapes[k]) != tuple(leaf.shape):
            raise ValueError(f"{where}: checkpoint leaf {k!r} has shape {tuple(shapes[k])}, the template expects "
                             f"{tuple(leaf.shape)} (the scenario config must match the one checkpointed)")


def _npz_path(path: str) -> str:
    # np.savez_compressed appends ".npz" when missing but np.load does not;
    # normalize so save/load round-trip with extension-less paths
    return path if path.endswith(".npz") else path + ".npz"


def _host(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_state(state: Any, path: str) -> None:
    """Write a tree of tensors (``WorldState``, dicts, lists, tuples) to
    ``path`` (.npz, host-local), each leaf under its name."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: _host(v) for k, v in _flatten(state).items()})


def load_state(template: Any, path: str) -> Any:
    """Load a tree saved by :func:`save_state`; ``template`` gives its
    structure, the dtypes and the device of every leaf."""
    path = _npz_path(path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    _check(_flatten(template), {k: v.shape for k, v in arrays.items()}, path)
    return _restore(template, arrays)


def _quiet_dcp(fn, *args, **kwargs):
    # without a process group dcp warns that it assumes one process, and on
    # an existing directory that it overwrites it, both as meant here
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        warnings.filterwarnings("ignore", message="Detected an existing checkpoint")
        return fn(*args, **kwargs)


def save_state_dcp(state: Any, path: str, prefix: str = "") -> None:
    """torch.distributed.checkpoint backend: the leaves of ``state`` by name
    (after ``prefix``) into the directory ``path``. With a process group
    running this is a collective call of every rank."""
    import torch.distributed.checkpoint as dcp

    flat = {prefix + k: torch.as_tensor(v).detach() for k, v in _flatten(state).items()}
    _quiet_dcp(dcp.save, flat, checkpoint_id=os.path.abspath(path))


def load_state_dcp(template: Any, path: str, prefix: str = "") -> Any:
    """Load the leaves named after ``prefix`` from a ``save_state_dcp``
    directory into the structure, dtypes and devices of ``template``."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    want = _flatten(template)
    shapes = {k[len(prefix):]: tuple(m.size) for k, m in meta.items() if k.startswith(prefix) and hasattr(m, "size")}
    _check(want, shapes, path)
    dest = {prefix + k: torch.empty(tuple(v.shape), dtype=torch.as_tensor(v).dtype,
                                    device=v.device if isinstance(v, torch.Tensor) else "cpu")
            for k, v in want.items()}
    _quiet_dcp(dcp.load, dest, checkpoint_id=path)
    return _restore(template, {k[len(prefix):]: v for k, v in dest.items()})


def _rank(env):
    """This rank's index where ``env`` is sharded over more than one rank,
    else None."""
    mesh = getattr(env, "mesh", None)
    if mesh is None or mesh.size() == 1:
        return None
    return mesh.get_local_rank()


def _env_tree(env):
    # the last observation seed drawn (BaseScenario.obs_seed) is state too:
    # football's team AI draws from its stream before the next step draws
    # a new one
    seed = np.frombuffer(int(env.scenario.obs_seed).to_bytes(8, "little"), np.uint8).copy()
    return {"state": env.state, "steps": env.steps, "generator": env.generator.get_state(), "obs_seed": seed}


def _check_backend(backend):
    if backend not in ("npz", "dcp"):
        raise ValueError(f"backend must be 'npz' or 'dcp' (the port's stand-in for orbax), got {backend!r}")


def save_env(env, path: str, backend: str = "npz") -> None:
    """Snapshot an Environment's full mutable state: the world state, the
    step counters and the generator's state. On a sharded env each rank
    writes its own shard (see the module docstring)."""
    _check_backend(backend)
    rank = _rank(env)
    if backend == "dcp":
        save_state_dcp(_env_tree(env), path, prefix="" if rank is None else f"rank{rank}/")
    else:
        save_state(_env_tree(env), path if rank is None else f"{_npz_path(path)[:-4]}.rank{rank}.npz")


def load_env(env, path: str, backend: str = "npz") -> None:
    """Restore a snapshot taken by :func:`save_env` into ``env`` (built with
    the same scenario config, on any device; a sharded env keeps its
    mesh)."""
    _check_backend(backend)
    rank = _rank(env)
    if backend == "dcp":
        restored = load_state_dcp(_env_tree(env), path, prefix="" if rank is None else f"rank{rank}/")
    else:
        restored = load_state(_env_tree(env), path if rank is None else f"{_npz_path(path)[:-4]}.rank{rank}.npz")
    env.state = restored["state"]
    env.steps = restored["steps"]
    env.generator.set_state(restored["generator"])
    env.scenario.obs_seed = int.from_bytes(restored["obs_seed"].tobytes(), "little")
