"""Tracing and profiling helpers (counterpart of vmas_tpu/profiling.py).

* :class:`StepTimer`: wall-clock phase timers with a device sync at exit,
  for per-phase step breakdowns.
* :func:`span`: a named range of the program (``vmas.ppo.update``,
  ``vmas.rows.launch``, ...) on the profiler's clock. It records while
  :func:`enable` is on or a ``torch.profiler`` session runs, and otherwise
  costs one flag check; :func:`summary` reads what the spans recorded.
* :func:`count`: a named count of work (``vmas.sensors.lidar.rays``, ...)
  beside the spans, recorded exactly when a span would record;
  :func:`counters` reads the totals.
* :func:`trace`: a context manager around ``torch.profiler.profile`` (CPU
  and CUDA activities) that writes a Chrome trace, plain JSON, into a
  directory: open it in ``chrome://tracing`` or Perfetto (no TensorBoard
  needed). The program's spans appear in it as host ranges.
* :func:`benchmark_fn`: steady-state seconds a call of a callable, warm-up
  excluded, the device synced at the end.

CUDA launches return before the device finishes, so a host clock without a
sync measures the enqueue only; these helpers sync the devices of the
tensors they are given, and a span on a device reads CUDA events, which
:func:`summary` waits for.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["StepTimer", "span", "count", "recording", "enable", "summary", "counters", "reset", "trace",
           "benchmark_fn"]

# a host range that the profiler records as an operation of the program
# (not as a user annotation, which the trace would also put on the device's
# timeline)
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def _sync(tree) -> None:
    """Wait for the devices holding the tensors of ``tree`` (nested dicts,
    lists, tuples, dataclasses such as ``WorldState``): one
    ``torch.cuda.synchronize(device)`` a CUDA device; CPU tensors are
    ready when they exist."""
    # imported here: the kernel loader and the fused step import this
    # module, so it loads nothing of the package at import
    from vmas_tpu_torch.core.utils import tree_leaves

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

    Each phase keeps its samples too, and a sample may carry a pair of
    recorded CUDA events (:func:`span`'s device clock), read at
    :meth:`summary`.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.samples: Dict[str, list] = defaultdict(list)
        self._events: Dict[str, list] = defaultdict(list)  # (start, end) pairs not read yet
        self._device_ms: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _sync(sync_on() if callable(sync_on) else sync_on)
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float, events=None) -> None:
        """One sample of ``name``: its host seconds, and its ``(start, end)``
        CUDA events where it has a device clock."""
        self.totals[name] += seconds
        self.counts[name] += 1
        self.samples[name].append(seconds)
        if events is not None:
            self._events[name].append(events)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per name: ``total_s``, ``count`` and ``mean_ms`` of the host
        clock, ``samples_ms`` (each sample's host ms) and, for a name with a
        device clock, ``device_ms`` (each sample's device ms between its
        events; the first summary after the samples waits for them)."""
        for name, pairs in self._events.items():
            for start, end in pairs:
                end.synchronize()
                self._device_ms[name].append(start.elapsed_time(end))
            pairs.clear()
        out = {}
        for k in self.totals:
            out[k] = {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
                "samples_ms": [1e3 * x for x in self.samples[k]],
            }
            if self._device_ms.get(k):
                out[k]["device_ms"] = list(self._device_ms[k])
        return out

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.samples.clear()
        self._events.clear()
        self._device_ms.clear()


# -- the program's spans -------------------------------------------------------

_recorder = StepTimer()
_counts: Dict[str, int] = defaultdict(int)
_enabled = False


class _Span:
    """A recording span: host ``perf_counter_ns`` at entry and exit, a
    CUDA event pair on ``stream`` where it has one, and, while a profiler
    session runs, a host range in its trace."""

    __slots__ = ("name", "stream", "t0", "start", "rf")

    def __init__(self, name, stream):
        self.name, self.stream = name, stream

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        events = None
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            events = (self.start, end)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        _recorder.add(self.name, (time.perf_counter_ns() - self.t0) * 1e-9, events)
        return False


# the span that records nothing
_OFF = contextlib.nullcontext()


def _stream_of(device):
    """The current CUDA stream of ``device`` (a ``torch.device``, its name
    or a tensor on it), or None where it is False or not a CUDA device."""
    if device is False or device is None:
        return None
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def span(name: str, device=False, always: bool = False):
    """A context manager naming a range of the program (``vmas.*``).

    It records while :func:`enable` is on or a ``torch.profiler`` session
    runs (``always``: in any case; for the once-a-process kernel load);
    otherwise it records nothing. A recording span takes the host clock
    at entry and exit, enters the profiler's trace as a host operation of
    that name where a session runs (so its idle gaps can be named by it),
    and with ``device`` (a CUDA device or a tensor on one) records a CUDA
    event pair on that device's current stream, read at :func:`summary`
    (no sync at the span). A count is its
    samples: ``vmas.rows.launch``'s count is the launches made while
    recording."""
    if not (_enabled or always or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, _stream_of(device))


def recording() -> bool:
    """Whether a span or a counter would record now: :func:`enable` is on,
    or a ``torch.profiler`` session runs (a site whose count takes work to
    work out asks first)."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (``vmas.*``) where :func:`recording`;
    otherwise one flag check. ``n`` is a host number, worked out from
    shapes, never read from the device."""
    if _enabled or _autograd_profiler._is_profiler_enabled:
        _counts[name] += int(n)


def enable(on: bool = True) -> None:
    """Record every span from now on (``on=False``: only while a profiler
    session runs). Meant for a bounded stretch, read with :func:`summary`
    and cleared with :func:`reset`: each sample is kept, and a device
    span's CUDA events until the next :func:`summary`."""
    global _enabled
    _enabled = bool(on)


def summary() -> Dict[str, Dict[str, float]]:
    """What the spans recorded, by name (:meth:`StepTimer.summary`)."""
    return _recorder.summary()


def counters() -> Dict[str, int]:
    """The counters' totals since the last :func:`reset`, by name."""
    return dict(_counts)


def reset() -> None:
    """Forget what the spans and counters recorded."""
    _recorder.reset()
    _counts.clear()


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
