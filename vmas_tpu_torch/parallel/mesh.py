"""Env-axis sharding over ``torch.distributed`` (counterpart of
vmas_tpu/parallel/mesh.py).

The JAX package shards one global state over a 1D ``Mesh(("env",))`` and
lets XLA run every step SPMD. PyTorch's form of that is one process per
rank: each rank holds the contiguous rows ``[r*B/n, (r+1)*B/n)`` of every
env-axis leaf and steps its own shard, and a one-dimensional
``DeviceMesh(("env",))`` names the ranks. Stepping needs no collective:
envs are independent. Only a learner's gradients and its batch
statistics cross ranks, each in one all-reduce through :func:`all_reduce`,
which counts them (``collectives``).

Random streams: after :func:`distribute` each rank's generator is reseeded
from the env's seed and its rank (:func:`rank_seed`). A sharded run is
therefore bitwise the single-process run under the same actions from the
same state, but not under random draws (random actions, noise, resets),
whereas the JAX package's threefry draws are global and shard-invariant.

:func:`spawn_ranks` starts the ranks of a run as processes on this machine
(the ``processes=`` of the examples), and :func:`init_rank` joins one to
the group.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vmas_tpu_torch.core.state import WorldState
from vmas_tpu_torch.core.utils import resolve_device, tree_leaves, tree_map

# collectives issued through all_reduce, in this process
collectives = 0

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def env_mesh(devices: Optional[Sequence] = None, n_devices: Optional[int] = None,
             backend: Optional[str] = None) -> DeviceMesh:
    """The 1D ``("env",)`` mesh over the ranks of the running process group.

    Where no group runs: with a launcher's variables set (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) it joins their group
    (``env://``); without them it makes a group of this one rank. The mesh's
    device type is that of ``devices`` (their first; one device per rank,
    or this rank's alone), else CUDA, which raises where there is no GPU:
    a mesh on the CPU is asked for with ``devices=["cpu"]``.
    ``backend`` defaults to ``nccl`` for CUDA and ``gloo`` for the CPU;
    ``gloo`` over CUDA tensors is allowed (NCCL refuses two ranks on one
    GPU). A running group of another backend than the one asked for
    raises; so does ``n_devices`` other than the group's size."""
    device_type = resolve_device(devices[0] if devices else None).type
    if not dist.is_initialized():
        backend = backend or ("nccl" if device_type == "cuda" else "gloo")
        if all(v in os.environ for v in _LAUNCHER_VARS):
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"a process group with backend {dist.get_backend()!r} is running; "
                         f"env_mesh does not switch it to {backend!r}")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"the mesh spans the {n} ranks of the process group, not {n_devices}; "
                         "start one process per rank")
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=("env",))


def mesh_size(mesh) -> int:
    """The mesh's number of ranks; 1 without a mesh."""
    return 1 if mesh is None else mesh.size()


def all_reduce(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``tensor`` over the mesh's ranks, in place: one collective,
    counted in ``collectives``."""
    global collectives
    collectives += 1
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return tensor


def mean_over_ranks(tensors, mesh):
    """Each tensor's mean over the mesh's ranks, in one flattened all-reduce
    (one bucket)."""
    bucket = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh) / mesh.size()
    return [b.view(t.shape) for b, t in zip(torch.split(bucket, [t.numel() for t in tensors]), tensors)]


def env_axis_size(tree, batch_dim: Optional[int] = None) -> int:
    """The env axis's size: ``batch_dim``, else a WorldState's own, else the
    most common leading size among the leaves of one dimension or more (the
    first of them on a tie), as the JAX package infers it."""
    if batch_dim is not None:
        return int(batch_dim)
    if isinstance(tree, WorldState):
        return int(tree.batch_dim)
    sizes = {}
    for leaf in tree_leaves(tree):
        if leaf.ndim > 0:
            sizes[leaf.shape[0]] = sizes.get(leaf.shape[0], 0) + 1
    if not sizes:
        raise ValueError("shard_state could not infer the env axis (no array leaves); pass batch_dim explicitly")
    return max(sizes, key=sizes.get)


def shard_state(tree, mesh, batch_dim: Optional[int] = None):
    """This rank's shard of a state tree: the contiguous rows ``[r*B/n,
    (r+1)*B/n)`` (copied) of every leaf whose leading dimension is the env
    axis (``env_axis_size``); every other leaf (a batchless table, a
    counter) is kept whole, replicated, as ``WorldState.blend`` treats
    it. Takes tensors and numpy arrays."""
    B = env_axis_size(tree, batch_dim)
    n, r = mesh.size(), mesh.get_local_rank()
    if B % n:
        raise ValueError(f"the env axis ({B}) must divide evenly over the mesh's {n} ranks")
    lo, hi = r * B // n, (r + 1) * B // n

    def place(x):
        if x.ndim > 0 and x.shape[0] == B:
            return x[lo:hi].clone() if isinstance(x, torch.Tensor) else x[lo:hi].copy()
        return x

    return tree_map(place, tree)


def rank_seed(seed: Optional[int], rank: int) -> int:
    """A rank's generator seed: the first 8 bytes of BLAKE2b over
    ``"<seed>:<rank>"`` (the env's seed, 0 where it had none), read as a
    little-endian integer."""
    digest = hashlib.blake2b(f"{0 if seed is None else seed}:{rank}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


def distribute(env, mesh=None):
    """Turn a live env of global size B into this rank's shard, in place.

    With one rank the env stays as it is. With n ranks it is built again
    at ``B / n`` envs from its own scenario class and arguments, so that
    every buffer sized by B follows (``num_envs``, the world, the steps,
    the rows buffers, the scenario's own tensors); it then takes this
    rank's rows of the global state and steps (``shard_state``), and its
    generator is reseeded with ``rank_seed(seed, rank)``. ``env.mesh`` is
    set either way. B must divide evenly over the ranks."""
    from vmas_tpu_torch.environment import Environment

    if mesh is None:
        mesh = env_mesh(devices=[env.device])
    n, rank = mesh.size(), mesh.get_local_rank()
    if env.num_envs % n:
        raise ValueError(f"num_envs={env.num_envs} must divide evenly over {n} ranks")
    if n > 1:
        B = env.num_envs
        state, steps = shard_state(env.state, mesh, B), shard_state(env.steps, mesh, B)
        kwargs = env._init_kwargs
        local = Environment(type(env.scenario)(), num_envs=B // n, device=env.device, **kwargs)
        env.__dict__.update(local.__dict__)
        env.state, env.steps = state, steps
        env.generator.manual_seed(rank_seed(kwargs["seed"], rank))
    env.mesh = mesh
    return env


# -- processes -------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world_size: int, init_method: str, backend: str = "gloo") -> None:
    """Join this process to the group of a spawned run as ``rank``."""
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def spawn_ranks(n: int, module: str, argv: Sequence[str], log_dir: str, timeout: float = 600,
                backend: str = "gloo", device=None) -> None:
    """Run ``python -m <module> <argv> --rank r --world_size n
    --init_method tcp://localhost:<port> --backend <backend>`` for each
    rank r of n, from the directory above the package, and wait for all.

    Each rank's output goes to ``log_dir/rank<r>.log``, a file and never a
    pipe: the ranks are coupled by collectives, and one blocked on writing
    into a full pipe that nothing drains would stall its peers. On a CUDA
    ``device`` the kernels are built here first, so that the ranks do not
    all run nvcc into the same directory. After ``timeout`` seconds every
    rank still running is killed; a rank that fails, or is killed, raises
    ``RuntimeError`` with the end of its log."""
    if device is not None and torch.device(device).type == "cuda":
        from vmas_tpu_torch import _kernels

        _kernels.build_all()
    root = pathlib.Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(root)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    for v in _LAUNCHER_VARS:
        env.pop(v, None)
    os.makedirs(log_dir, exist_ok=True)
    init = f"tcp://localhost:{free_port()}"
    logs = [open(os.path.join(log_dir, f"rank{r}.log"), "w+b") for r in range(n)]
    procs, killed = [], set()
    try:
        for r in range(n):
            cmd = [sys.executable, "-m", module, *map(str, argv), "--rank", str(r), "--world_size", str(n),
                   "--init_method", init, "--backend", backend]
            procs.append(subprocess.Popen(cmd, stdout=logs[r], stderr=subprocess.STDOUT, cwd=str(root), env=env))
        # until all end, one fails (its peers would wait on it), or time runs out
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
                killed.add(r)
        tails = []
        for f in logs:
            f.seek(0)
            tails.append(f.read().decode(errors="replace")[-4000:])
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        r = min(bad, key=lambda r: r in killed)  # a rank that failed by itself first
        why = f"was killed after {timeout} s" if r in killed else f"failed with code {procs[r].returncode}"
        raise RuntimeError(f"rank {r} of {n} ({module}) {why}:\n{tails[r]}")
