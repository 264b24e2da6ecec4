"""Milliseconds of a rollout call's launch loop on the device's clock: the
program's span ``vmas.rows.loop`` (CUDA events at its entry and exit), median
over the traced calls."""

from portbench import spans


def read(r):
    if r.get("kind") != "rollout":
        return None
    return spans.device_median_ms("vmas.rows.loop")
