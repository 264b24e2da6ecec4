"""Milliseconds of one update's batch (``rows_batch``: the values and
GAE) on the device's clock: the program's span ``vmas.ppo.batch``, mean over
the traced updates."""

from portbench import spans


def read(r):
    if r.get("kind") != "ppo":
        return None
    return spans.device_mean_ms("vmas.ppo.batch")
