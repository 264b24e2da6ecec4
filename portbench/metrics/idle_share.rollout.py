"""The device's idle share over the traced calls of a rollout: 100 x (1 -
the union of the device's activity intervals over the traced wall time)."""


def read(r):
    if r.get("kind") != "rollout" or not r.get("window_s") or "busy_s" not in r:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
