"""The program's spans (``vmas_tpu_torch.profiling``) as the per-layer
metrics read them.

In a ``--trace 1`` run a span records only while the traced stretch runs
under the profiler (``harness.profile``), so its readings are of the same
updates or calls as the device's idle share; the kernels' load records in
every run. Each function returns None where the program has no span
recorder (a program from before the spans) or the span recorded nothing.
"""

from __future__ import annotations

import statistics


def summary_of(name: str):
    """Span ``name``'s summary (``total_s``, ``count``, ``samples_ms`` and,
    on the device's clock, ``device_ms``), or None."""
    from vmas_tpu_torch import profiling

    summary = getattr(profiling, "summary", None)
    if summary is None:
        return None
    s = summary().get(name)
    return s if s and s.get("count") else None


def device_mean_ms(name: str):
    """The mean of the span's device milliseconds."""
    s = summary_of(name)
    return statistics.fmean(s["device_ms"]) if s and s.get("device_ms") else None


def device_median_ms(name: str):
    """The median of the span's device milliseconds."""
    s = summary_of(name)
    return statistics.median(s["device_ms"]) if s and s.get("device_ms") else None


def host_median_ms(name: str):
    """The median of the span's host milliseconds."""
    s = summary_of(name)
    return statistics.median(s["samples_ms"]) if s else None


def host_total_s(name: str):
    """The span's host seconds, summed over the process."""
    s = summary_of(name)
    return s["total_s"] if s else None
