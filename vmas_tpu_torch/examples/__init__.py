"""The examples of vmas_tpu_torch, counterparts of the repo's ``examples/``:
``use_vmas_tpu_env``, ``run_heuristic``, ``speed_sweep``, ``train_ppo`` and
``train_sharded``. Each has a ``main(...)`` with the JAX example's keyword
arguments and ``device=`` (the GPU unless it says otherwise), and runs as
``python -m vmas_tpu_torch.examples.<name>``. ``train_ppo`` and
``train_sharded`` take ``processes=N`` in place of the JAX examples'
``virtual_devices``: N ranks as processes of this machine, joined by gloo
(``parallel.mesh.spawn_ranks``), each stepping its shard of the envs.

The helpers here are the examples' plumbing: a device sync for timing, the
rank flags a spawned rank is started with, and the spawn itself.
"""

from __future__ import annotations

import argparse
import tempfile

import torch
import torch.distributed as dist


def sync(device) -> None:
    """Wait for the device's queued work (timings end here)."""
    if torch.device(device if device is not None else "cuda").type == "cuda":
        torch.cuda.synchronize()


def add_rank_args(parser) -> None:
    """The flags ``spawn_ranks`` starts each rank with (not in ``--help``)."""
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--world_size", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--init_method", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)


def launch(module: str, processes: int, options: dict, log_dir=None, timeout: float = 1800) -> None:
    """Run ``module``'s main in ``processes`` gloo ranks with ``options`` as
    its flags (a True bool as a bare flag, None and False left out), wait
    for them, and print rank 0's log. Each rank's log is a file under
    ``log_dir`` (a new temporary directory by default)."""
    from vmas_tpu_torch.parallel.mesh import spawn_ranks

    argv = []
    for k, v in options.items():
        if v is None or v is False:
            continue
        argv += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    log_dir = log_dir or tempfile.mkdtemp(prefix="vmas_tpu_torch_ranks_")
    spawn_ranks(processes, module, argv, log_dir, timeout=timeout, device=options.get("device"))
    with open(f"{log_dir}/rank0.log") as f:
        print(f.read(), end="")
    print(f"{processes} ranks done; their logs are in {log_dir}")


class RankGroup:
    """``with RankGroup(rank, world_size, init_method, backend):`` joins a
    spawned rank's group where ``rank`` is given, and at exit destroys the
    process group if it was made inside the block (the join's, or the
    one-rank group ``parallel.distribute`` makes where none runs)."""

    def __init__(self, rank, world_size, init_method, backend):
        self.args = (rank, world_size, init_method, backend)

    def __enter__(self):
        from vmas_tpu_torch.parallel.mesh import init_rank

        self.had = dist.is_initialized()
        if self.args[0] is not None:
            init_rank(*self.args)
        return self

    def __exit__(self, *exc):
        if not self.had and dist.is_initialized():
            dist.destroy_process_group()
