"""Tracing and profiling helpers (counterpart of vmas_tpu/profiling.py).

* :class:`StepTimer`: wall-clock phase timers with a device sync at exit,
  for per-phase step breakdowns.
* :func:`trace`: a context manager around ``torch.profiler.profile`` (CPU
  and CUDA activities) that writes a Chrome trace, plain JSON, into a
  directory: open it in ``chrome://tracing`` or Perfetto (no TensorBoard
  needed).
* :func:`benchmark_fn`: steady-state seconds a call of a callable, warm-up
  excluded, the device synced at the end.

CUDA launches return before the device finishes, so a host clock without a
sync measures the enqueue only; these helpers sync the devices of the
tensors they are given.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import torch

from vmas_tpu_torch.core.utils import tree_leaves

__all__ = ["StepTimer", "trace", "benchmark_fn"]


def _sync(tree) -> None:
    """Wait for the devices holding the tensors of ``tree`` (nested dicts,
    lists, tuples, dataclasses such as ``WorldState``): one
    ``torch.cuda.synchronize(device)`` a CUDA device; CPU tensors are
    ready when they exist."""
    for d in {t.device for t in tree_leaves(tree) if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(d)


class StepTimer:
    """Accumulating named phase timer.

    A phase without ``sync_on`` measures dispatch only: the host returns
    from a CUDA launch before the device runs it, and the device time lands
    in whichever later phase first waits. Pass ``sync_on`` to wait at exit:

    * a zero-arg callable, evaluated AT EXIT -- closures are late-bound, so
      ``lambda: state`` picks up the ``state`` assigned inside the block:

      >>> timer = StepTimer()
      >>> with timer.phase("physics", sync_on=lambda: state):
      ...     state = step(state)      # doctest: +SKIP

    * or a tree of tensors, synced as it is (for values known up front).

    The devices of the tensors found are synchronised
    (``torch.cuda.synchronize(device)``).
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _sync(sync_on() if callable(sync_on) else sync_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU and, where CUDA is
    available, CUDA activities) and write its Chrome trace to
    ``log_dir/trace.json``. Yields the profiler (its ``events()`` and
    ``key_averages()`` are there after the block)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def benchmark_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2):
    """Steady-state seconds a call of ``fn(*args)``: ``warmup`` untimed calls
    (kernel builds, allocator warm-up; pass 0 to time the first call too),
    then ``iters`` timed calls and one device sync of the last output.
    Returns ``(mean_seconds, last_output)``."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters, out
