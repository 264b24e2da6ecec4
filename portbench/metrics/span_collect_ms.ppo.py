"""Milliseconds of one update's collection on the device's clock: the
program's span ``vmas.ppo.collect`` (CUDA events at its entry and exit),
mean over the traced updates."""

from portbench import spans


def read(r):
    if r.get("kind") != "ppo":
        return None
    return spans.device_mean_ms("vmas.ppo.collect")
