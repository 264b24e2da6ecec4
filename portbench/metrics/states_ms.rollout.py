"""Milliseconds of a rollout call's rebuild of each step's state and the
``unpack`` over it (the Lidar included) on the device's clock: the program's
span ``vmas.rows.states``, inside ``vmas.rows.finish``, median over the
traced calls."""

from portbench import spans


def read(r):
    if r.get("kind") != "rollout":
        return None
    return spans.device_median_ms("vmas.rows.states")
