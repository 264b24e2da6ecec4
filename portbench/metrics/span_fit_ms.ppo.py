"""Milliseconds of one update's ``fit`` (its epochs of Adam steps) on the
device's clock: the program's span ``vmas.ppo.fit``, mean over the traced
updates."""

from portbench import spans


def read(r):
    if r.get("kind") != "ppo":
        return None
    return spans.device_mean_ms("vmas.ppo.fit")
